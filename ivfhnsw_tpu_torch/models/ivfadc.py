"""IVFADC index on PyTorch — counterpart of
``ivfhnsw_tpu/models/ivfadc.py::IVFADCIndex`` (itself the equivalent of the
reference's ``ivfhnsw::IndexIVF_HNSW``).

Ported so far: the build path (``train_centroids``/``set_centroids``,
``assign``, ``train_pq`` with or without OPQ, ``add_batch`` + ``finalize``)
and ``search`` with engines

- ``"torch"`` — the portable gather + top-k path (``ops.adc``), counterpart
  of the JAX ``"xla"`` engine and the oracle for the fused one;
- ``"fused"`` — coarse, LUTs, slot schedule, the hand-written scan kernel,
  bin-32 top-k and id resolution (``ops.cuda.adc_scan.search_core``),
  counterpart of the JAX ``"pallas"`` engine;
- ``"auto"`` — ``"fused"``.

Every tensor of an index lives on the ``device`` it was created with; the
fused engine runs its scan kernel on a CUDA device and the kernel's plain
version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.storage import (PostingListBuilder,
                                              PostingListStore)
from ivfhnsw_tpu_torch.ops import adc as adc_ops
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as fused
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.kmeans import kmeans
from ivfhnsw_tpu_torch.ops.opq import (apply_rotation,
                                       apply_rotation_transpose, train_opq)
from ivfhnsw_tpu_torch.ops.pq import (ENCODE_ROWS, NormQuantizer,
                                      ProductQuantizer, _pq_ip_luts)
from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams

# Average codes per list at and above which "auto" picks 1024-code slots
# (the JAX package's quad/chunk crossover, ivfadc.py:486-500).
QUAD_MIN_AVG_LIST = 416
# Centroid rows per coarse sweep step of assignment and the torch engine.
COARSE_BLOCK = 16384


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class IVFADCIndex:
    """IVFADC: exact matmul coarse quantizer + residual PQ + 1-byte norm PQ,
    with flat posting lists."""

    def __init__(self, config: IndexConfig, device):
        self.config = config.validate()
        self.device = torch.device(device)
        self.d = config.d
        self.nc = config.nc
        self.do_opq = config.do_opq

        self.centroids: torch.Tensor | None = None       # [nc, d] f32
        self.centroid_norms: torch.Tensor | None = None  # [nc] f32
        self.pq = ProductQuantizer(config.d, config.pq_m, config.ksub)
        self.norm_pq = NormQuantizer(config.ksub)
        self.opq_R: torch.Tensor | None = None           # [d, d] f32
        self.builder = PostingListBuilder(config.nc, config.pq_m)
        self.store: PostingListStore | None = None

        # Defaults mirroring IndexIVF_HNSW.h:61-62 (overridable per call).
        self.nprobe = 32
        self.max_codes = 10000
        self.engine = "auto"        # "torch" | "fused" | "auto" (= fused)
        # Fused-engine slot width: "chunk" = 256 codes, "quad" = 1024, or
        # "auto" by average list size (see _resolve_layout).
        self.scan_layout = "auto"

    @classmethod
    def from_numpy_state(cls, config: IndexConfig, centroids, codebooks,
                         norm_centroids, codes, ids, norm_codes, list_offsets,
                         device, opq_R=None) -> "IVFADCIndex":
        """Build an index from another index's arrays, given as numpy:
        centroids [nc, d], PQ codebooks [M, 256, dsub], norm-PQ centroids
        [256], the store's flat codes / ids / norm_codes / list_offsets and,
        with OPQ, the rotation R [d, d] (e.g. ``np.asarray`` of the JAX
        package's ``IVFADCIndex`` fields). The builder is seeded from the
        store, so later ``add_batch`` + ``finalize`` calls extend it."""
        idx = cls(config, device)
        idx.set_centroids(centroids)
        idx.pq.codebooks = idx._tensor(codebooks)
        idx.norm_pq.centroids = idx._tensor(norm_centroids)
        if opq_R is not None:
            idx.opq_R = idx._tensor(opq_R)
        offsets = np.asarray(list_offsets, np.int64)
        keys = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                         np.diff(offsets))
        idx.builder.add(keys, ids, codes, norm_codes)
        idx.finalize()
        return idx

    def _tensor(self, x) -> torch.Tensor:
        """float32 tensor on this index's device (numpy or tensor in)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def _keys(self, keys) -> torch.Tensor:
        if isinstance(keys, torch.Tensor):
            return keys.to(device=self.device, dtype=torch.int64)
        return torch.tensor(np.asarray(keys, np.int64), device=self.device)

    def _keys_for(self, x: torch.Tensor, precomputed_idx) -> torch.Tensor:
        """Centroid ids of device rows x: ``precomputed_idx`` when given,
        else nearest-centroid assignment."""
        return (self._keys(precomputed_idx) if precomputed_idx is not None
                else self._assign_t(x))

    # ------------------------------------------------------------------
    # Quantizer setup
    # ------------------------------------------------------------------

    def train_centroids(self, generator: torch.Generator, train_data,
                        niter: int = 20) -> None:
        """Coarse centroid learning on the device (the reference takes the
        centroids from an external k-means tool, README.md:56,62)."""
        cents, _ = kmeans(generator, self._tensor(train_data), self.nc,
                          niter=niter)
        self.set_centroids(cents)

    def set_centroids(self, centroids) -> None:
        """build_quantizer equivalent (IndexIVF_HNSW.cpp:40-65): install the
        coarse centroids; the exact matmul top-k is the quantizer."""
        centroids = self._tensor(centroids).contiguous()
        if tuple(centroids.shape) != (self.nc, self.d):
            raise ValueError(f"centroids shape {tuple(centroids.shape)} != "
                             f"({self.nc}, {self.d})")
        self.centroids = centroids
        self.compute_centroid_norms()

    def compute_centroid_norms(self) -> None:
        """IndexIVF_HNSW.cpp:781-787."""
        self.centroid_norms = (self.centroids * self.centroids).sum(dim=1)

    # ------------------------------------------------------------------
    # Assignment / training
    # ------------------------------------------------------------------

    def _assign_t(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-centroid ids [n] int64 of device rows x, in batches that
        keep each [batch, block] score matrix under ~256 MB."""
        batch = max(1024, min(131072, (1 << 26) // min(COARSE_BLOCK,
                                                       self.nc)))
        out = torch.empty(x.shape[0], dtype=torch.int64, device=self.device)
        for off in range(0, x.shape[0], batch):
            _, idx = streaming_topk_l2(x[off:off + batch], self.centroids, 1,
                                       block=COARSE_BLOCK,
                                       point_sqnorms=self.centroid_norms)
            out[off:off + batch] = idx[:, 0]
        return out

    def assign(self, x) -> np.ndarray:
        """Nearest-centroid ids for x [n, d] (IndexIVF_HNSW.cpp:68-72).
        Returns int32 [n] on the host."""
        return self._assign_t(self._tensor(x)).cpu().numpy().astype(np.int32)

    def compute_residuals(self, x, keys) -> torch.Tensor:
        """x - centroid[key] (IndexIVF_HNSW.cpp:825-831)."""
        return self._tensor(x) - self.centroids[self._keys(keys)]

    def reconstruct(self, decoded_residuals, keys) -> torch.Tensor:
        """decoded residual + centroid (IndexIVF_HNSW.cpp:817-823)."""
        return self._tensor(decoded_residuals) + self.centroids[
            self._keys(keys)]

    def train_pq(self, generator: torch.Generator, train_data,
                 precomputed_idx=None, pq_niter: int = 25,
                 opq_niter: int = 20) -> None:
        """train_pq equivalent (IndexIVF_HNSW.cpp:536-593): assign,
        residuals, [OPQ], PQ, then norm-PQ on the reconstructions' norms."""
        x = self._tensor(train_data)
        keys = self._keys_for(x, precomputed_idx)
        self._train_quantizers(generator, self.compute_residuals(x, keys),
                               self.centroids[keys], pq_niter, opq_niter)

    def _train_quantizers(self, generator: torch.Generator,
                          residuals: torch.Tensor, base: torch.Tensor,
                          pq_niter: int, opq_niter: int) -> None:
        """[OPQ rotation +] PQ on ``residuals``, then the norm quantizer on
        the norms of the reconstructions decoded + ``base``."""
        if self.do_opq:
            self.opq_R, self.pq = train_opq(
                generator, residuals, self.config.pq_m, niter=opq_niter,
                final_pq_niter=pq_niter, ksub=self.config.ksub)
        else:
            self.pq.train(generator, residuals, niter=pq_niter)
        recon = self._decode(self.pq.encode(self._rotate(residuals))) + base
        self.norm_pq.train(generator, (recon * recon).sum(dim=1))

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        """x @ R.T under OPQ (residuals before PQ, queries before their
        LUTs); x itself otherwise."""
        if not self.do_opq:
            return x
        if self.opq_R is None:
            raise RuntimeError("OPQ index has no rotation: call train_pq "
                               "first")
        return apply_rotation(x, self.opq_R)

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        """PQ decode, rotated back to the original space under OPQ."""
        decoded = self.pq.decode(codes)
        if self.do_opq:
            decoded = apply_rotation_transpose(decoded, self.opq_R)
        return decoded

    # ------------------------------------------------------------------
    # Adding vectors
    # ------------------------------------------------------------------

    def _encode_batch(self, x: torch.Tensor, keys: torch.Tensor):
        """Codes of x [n, d] against the centroids of ``keys``, in pieces of
        ENCODE_ROWS rows. Returns (codes [n, M] u8, norm_codes [n] u8) on
        the device."""
        n = x.shape[0]
        codes = torch.empty((n, self.config.pq_m), dtype=torch.uint8,
                            device=self.device)
        norm_codes = torch.empty(n, dtype=torch.uint8, device=self.device)
        for s in range(0, n, ENCODE_ROWS):
            base = self.centroids[keys[s:s + ENCODE_ROWS]]
            codes[s:s + ENCODE_ROWS], norm_codes[s:s + ENCODE_ROWS] = (
                self._encode(x[s:s + ENCODE_ROWS], base))
        return codes, norm_codes

    def _encode(self, x: torch.Tensor, base: torch.Tensor):
        """residual against ``base`` -> [rotate] -> PQ -> decode ->
        [unrotate] -> reconstruct -> norm code (IndexIVF_HNSW.cpp:87-121).
        Returns (codes [n, M] u8, norm_codes [n] u8)."""
        codes = self.pq.encode(self._rotate(x - base))
        recon = self._decode(codes) + base
        return codes, self.norm_pq.encode((recon * recon).sum(dim=1))

    def add_batch(self, x, xids=None, precomputed_idx=None) -> None:
        """add_batch equivalent (IndexIVF_HNSW.cpp:75-138). Call finalize()
        after the last batch."""
        x = self._tensor(x)
        n = x.shape[0]
        keys = self._keys_for(x, precomputed_idx)
        if xids is None:
            xids = np.arange(self.builder.ntotal, self.builder.ntotal + n,
                             dtype=np.int32)
        codes, norm_codes = self._encode_batch(x, keys)
        self.builder.add(keys.cpu().numpy(), xids, codes.cpu().numpy(),
                         norm_codes.cpu().numpy())
        self.store = None

    def finalize(self) -> None:
        self.store = self.builder.finalize(self.device)

    def _ensure_store(self) -> PostingListStore:
        if self.store is None:
            self.finalize()
        return self.store

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _scan_budget(self, params: SearchParams) -> int:
        """Padded scan length of the torch engine: budget + the one list
        allowed to cross it (IndexIVF_HNSW.cpp:290-292), rounded to 128."""
        if params.scan_budget is not None:
            return params.scan_budget
        mx = self._ensure_store().max_list_size()
        if params.max_codes and params.max_codes > 0:
            budget = params.max_codes + mx
        else:
            budget = mx * params.nprobe
        return _round_up(max(budget, 128), 128)

    def _resolve_engine(self) -> str:
        if self.engine not in ("auto", "torch", "fused"):
            raise ValueError(f"unknown engine {self.engine!r}; expected one "
                             "of auto/torch/fused")
        return "fused" if self.engine == "auto" else self.engine

    def _resolve_layout(self) -> str:
        """Slot width of the fused engine: "quad" (1024 codes) when the
        average list fills enough of a 1024-code slot, else "chunk" (256)."""
        if self.scan_layout not in ("auto", "chunk", "quad"):
            raise ValueError(f"unknown scan_layout {self.scan_layout!r}")
        if self.scan_layout != "auto":
            return self.scan_layout
        avg = self._ensure_store().ntotal / max(1, self.nc)
        return "quad" if avg >= QUAD_MIN_AVG_LIST else "chunk"

    def scan_gran(self) -> int:
        """Codes per fused-engine slot under the resolved layout."""
        return fused.RCHUNK if self._resolve_layout() == "quad" else fused.CHUNK

    def _scan_slots(self, params: SearchParams, nprobe: int) -> int:
        """Slot count of the fused engine (the JAX package's _pallas_nch):
        the worst case of the max_codes budget, capped by
        ``params.scan_budget`` (lanes); slots beyond the cap drop the
        farthest probes' tails."""
        mx = self._ensure_store().max_list_size()
        gran = self.scan_gran()
        if params.max_codes and params.max_codes > 0:
            nslots = (params.max_codes + mx) // gran + nprobe + 1
        else:
            nslots = nprobe * max(1, (mx + gran - 1) // gran)
        if params.scan_budget is not None:
            nslots = min(nslots, -(-params.scan_budget // gran))
        return max(nslots, 1)

    def _exact_reduce(self, params: SearchParams) -> str:
        """Coarse selection: only exact modes are ported ("auto" = exact)."""
        mode = params.coarse_mode
        if mode in ("auto", "exact"):
            return "topk"
        if mode == "binned":
            return "binned"
        raise NotImplementedError(f"coarse_mode={mode!r} is not ported yet")

    def _coarse_block_for(self, B: int) -> int:
        """Coarse sweep block of the fused engine for a batch of B queries:
        as wide as a ~64 MB [B, block] f32 score block allows."""
        cap = max(4096, ((64 << 20) // max(B, 1)) // 128 * 128)
        return min(_round_up(self.nc, 128), cap)

    def _search_torch(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, L: int):
        """Portable engine (the JAX ``_search_core``): gather the scan
        window, 3-term ADC, top-k."""
        store = self.store
        qc_dists, probes = streaming_topk_l2(
            q, self.centroids, nprobe, block=COARSE_BLOCK,
            point_sqnorms=self.centroid_norms)
        luts = _pq_ip_luts(self._rotate(q), self.pq.codebooks)
        pos, seg, valid, _ = adc_ops.probe_positions(
            probes, store.list_offsets_t, params.max_codes, L)
        g_norm = self.norm_pq.centroids[store.norm_codes_t[pos].long()]
        term1 = torch.gather(qc_dists - self.centroid_norms[probes], 1, seg)
        dists, sel = adc_ops.adc_scan(luts, store.codes_t[pos],
                                      term1 + g_norm, valid, params.k)
        labels = torch.gather(store.ids_t[pos], 1, sel).long()
        return dists, torch.where(torch.isfinite(dists), labels, -1)

    def _search_fused(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, nslots: int, gran: int,
                      exact_reduce: str):
        """Fused engine: ``ops.cuda.adc_scan.search_core``."""
        store = self.store
        return fused.search_core(
            q, self.centroids, self.centroid_norms, self.pq.codebooks,
            self.norm_pq.centroids, store.codes_t, store.ids_t,
            store.norm_codes_t, store.list_offsets_t, params.max_codes,
            nprobe=nprobe, k=params.k, nslots=nslots, gran=gran,
            coarse_block=self._coarse_block_for(q.shape[0]),
            exact_reduce=exact_reduce,
            lut_queries=self._rotate(q))

    def _default_params(self) -> SearchParams:
        return SearchParams(k=10, nprobe=self.nprobe,
                            max_codes=self.max_codes)

    def search(self, queries, params: SearchParams | None = None,
               batch: int = 8192):
        """Batched query search, ``batch`` queries per pass. Returns
        (dists [nq, k] f32, labels [nq, k] int64) on the host; label -1
        where fewer than k codes were scanned. (The JAX package caps its
        kernel batch at 1024 for TPU scalar memory; nothing here needs
        that cap.)"""
        params = params or self._default_params()
        self._ensure_store()
        q_all = self._tensor(queries)
        nprobe = min(params.nprobe, self.nc)
        engine = self._resolve_engine()
        exact_reduce = self._exact_reduce(params)
        if engine == "torch":
            L = self._scan_budget(params)
        else:
            nslots, gran = self._scan_slots(params, nprobe), self.scan_gran()
        out_d, out_l = [], []
        for off in range(0, q_all.shape[0], batch):
            q = q_all[off:off + batch]
            if engine == "torch":
                d, l = self._search_torch(q, params, nprobe, L)
            else:
                d, l = self._search_fused(q, params, nprobe, nslots, gran,
                                          exact_reduce)
            out_d.append(d)
            out_l.append(l)
        return (torch.cat(out_d).cpu().numpy(),
                torch.cat(out_l).cpu().numpy())
