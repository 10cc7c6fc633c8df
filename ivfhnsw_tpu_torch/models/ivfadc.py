"""IVFADC index on PyTorch — counterpart of
``ivfhnsw_tpu/models/ivfadc.py::IVFADCIndex`` (itself the equivalent of the
reference's ``ivfhnsw::IndexIVF_HNSW``).

Ported so far: the build path (``train_centroids``/``set_centroids``,
``assign``, ``train_pq`` with or without OPQ, ``add_batch`` + ``finalize``)
and the query surface: ``search`` (host arrays in and out) and
``search_device`` (tensors on the device in and out) over one per-batch
core with engines

- ``"torch"`` — the portable gather + top-k path (``ops.adc``), counterpart
  of the JAX ``"xla"`` engine and the oracle for the fused one;
- ``"fused"`` — coarse, LUTs, slot schedule, the hand-written scan kernel,
  top-k and id resolution (``ops.cuda.adc_scan.search_core``), counterpart
  of the JAX ``"pallas"`` engine, with the wide or the two-phase top-k
  (``scan_topk``);
- ``"auto"`` — ``"fused"``;

``search(trace=True)`` (the reference's search_debug: per-query probes,
their distances, which made the budget and the codes scanned, from the
torch engine whatever ``engine`` says) with the ``stats`` counters,
``scan_slot_demand`` (profiled slot counts), ``search_precomputed``,
``search_per_probe`` and ``search_enn``; the device-resident build
(``add_batch_device``) and ``release_device``; the large-nc path: the
routed two-level assigner (``enable_fast_assign``), routed coarse selection
(``enable_routed_coarse``, ``coarse_mode="routed"``), the approximate and
binned coarse modes and the user ``coarse_block`` ceiling; and the file IO:
``write`` /
``read`` (the reference's ``.index`` format, byte-identical to the JAX
package's), ``write2`` (the ORCV home dir) and ``add_batch2`` (ORCV output
records), ``reseed_builder_from_store``, ``save_quantizers`` /
``load_quantizers`` (faiss ``.pq`` and ``.opq``) and ``load_centroids``
(``.fvecs``).

Every tensor of an index lives on the ``device`` it was created with; the
fused engine runs its scan kernels on a CUDA device and the kernels' plain
versions on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.storage import (PostingListBuilder,
                                              PostingListStore)
from ivfhnsw_tpu_torch.ops import adc as adc_ops
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as fused
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget
from ivfhnsw_tpu_torch.ops.kmeans import kmeans
from ivfhnsw_tpu_torch.ops.opq import (apply_rotation,
                                       apply_rotation_transpose, load_rotation,
                                       save_rotation, train_opq)
from ivfhnsw_tpu_torch.ops.pq import (ENCODE_ROWS, NormQuantizer,
                                      ProductQuantizer, _pq_decode,
                                      _pq_encode, _pq_ip_luts, norm_encode)
from ivfhnsw_tpu_torch.ops.topk import topk_smallest
from ivfhnsw_tpu_torch.utils import io
from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams
from ivfhnsw_tpu_torch.utils.profiling import COUNTERS, span, tracing

# Average codes per list at and above which "auto" picks 1024-code slots
# (the JAX package's quad/chunk crossover, ivfadc.py:486-500).
QUAD_MIN_AVG_LIST = 416
# Centroid rows per coarse sweep step of assignment, training and the torch
# engine, unless the user's ``coarse_block`` says otherwise.
COARSE_BLOCK = 16384
# Centroid count above which coarse_mode "auto" adopts routed selection
# when the routing structure exists (the JAX package's rule).
AUTO_ROUTED_NC = 16384
COARSE_MODES = ("auto", "exact", "binned", "approx", "routed")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_layout(scan_layout: str, ntotal: int, nc: int) -> str:
    """Slot width of the fused engine under ``scan_layout``: "quad" (1024
    codes) when "auto" and the average list (ntotal / nc) fills enough of a
    1024-code slot, else "chunk" (256)."""
    if scan_layout not in ("auto", "chunk", "quad"):
        raise ValueError(f"unknown scan_layout {scan_layout!r}")
    if scan_layout != "auto":
        return scan_layout
    return "quad" if ntotal / max(1, nc) >= QUAD_MIN_AVG_LIST else "chunk"


def resolve_two_phase(scan_topk: str) -> bool:
    """Whether the fused engine takes the two-phase top-k. "auto" resolves
    to wide, the JAX package's rule (its models/ivfadc.py:473-484, measured
    there on a TPU); only "twophase" selects it."""
    if scan_topk not in ("auto", "wide", "twophase"):
        raise ValueError(f"unknown scan_topk {scan_topk!r}; expected one of "
                         "auto/wide/twophase")
    return scan_topk == "twophase"


def encode_batch(x: torch.Tensor, keys: torch.Tensor,
                 centroids: torch.Tensor, codebooks: torch.Tensor,
                 norm_centroids: torch.Tensor, R: torch.Tensor | None = None):
    """:func:`encode_against` of x [n, d] against ``centroids[keys]``, in
    pieces of ENCODE_ROWS rows. Returns (codes [n, M] u8, norm_codes [n]
    u8) on x's device."""
    n = x.shape[0]
    codes = torch.empty((n, codebooks.shape[0]), dtype=torch.uint8,
                        device=x.device)
    norm_codes = torch.empty(n, dtype=torch.uint8, device=x.device)
    for s in range(0, n, ENCODE_ROWS):
        codes[s:s + ENCODE_ROWS], norm_codes[s:s + ENCODE_ROWS] = (
            encode_against(x[s:s + ENCODE_ROWS],
                           centroids[keys[s:s + ENCODE_ROWS]], codebooks,
                           norm_centroids, R))
    return codes, norm_codes


def coarse_block_for(nc: int, B: int, ceiling: int | None = None) -> int:
    """Coarse sweep block of the fused engine over nc centroids for a batch
    of B queries: ``ceiling`` (the user's ``coarse_block``) when given,
    else as wide as a ~64 MB [B, block] f32 score block allows."""
    if ceiling:
        return min(_round_up(nc, 128), ceiling)
    cap = max(4096, ((64 << 20) // max(B, 1)) // 128 * 128)
    return min(_round_up(nc, 128), cap)


def encode_against(x: torch.Tensor, base: torch.Tensor,
                   codebooks: torch.Tensor, norm_centroids: torch.Tensor,
                   R: torch.Tensor | None = None):
    """residual x - base -> [rotate by R] -> PQ -> decode -> [unrotate] ->
    reconstruct -> norm code of the reconstruction (IndexIVF_HNSW.cpp:
    87-121). Returns (codes [n, M] u8, norm_codes [n] u8)."""
    r = x - base
    if R is not None:
        r = apply_rotation(r, R)
    codes = _pq_encode(r.float(), codebooks)
    decoded = _pq_decode(codes, codebooks)
    if R is not None:
        decoded = apply_rotation_transpose(decoded, R)
    recon = decoded + base
    return codes, norm_encode((recon * recon).sum(dim=1), norm_centroids)


def read_index_header(path: str) -> tuple[int, int]:
    """(d, nc) from the first 16 bytes of an ``.index`` file."""
    with open(path, "rb") as f:
        d, nc = (int(v) for v in np.fromfile(f, "<u8", 2))
    return d, nc


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
        # ORCV match thresholds (IndexIVF_HNSW.h:90-91 defaults).
        self.dmatch = 4444.0
        self.dnear = 8888.0
        # Coarse sweep block (centroid rows per step). None = automatic
        # (COARSE_BLOCK for assignment and the torch engine, batch-aware
        # for the fused engine); an int is a ceiling every path honours,
        # bounding the [batch, block] score buffer.
        self.coarse_block: int | None = None
        # The routed two-level assigner (enable_fast_assign) and the routed
        # coarse structure (enable_routed_coarse), when enabled.
        self._fast_assigner = None
        self._routed_coarse = None
        self._routed_table = None   # (structure, store, fused-engine args)
        self.routed_w = 16
        self.engine = "auto"        # "torch" | "fused" | "auto" (= fused)
        # Fused-engine slot width: "chunk" = 256 codes, "quad" = 1024, or
        # "auto" by average list size (see _resolve_layout).
        self.scan_layout = "auto"
        # Fused-engine top-k: "wide" scans every lane of every slot and
        # top-ks them all; "twophase" takes per-slot minima from the
        # min-scan kernel, picks the k best slots and rescans only those
        # (ops.cuda.adc_scan.two_phase_topk); "auto" = "wide", the JAX
        # package's rule (see _resolve_two_phase). The torch engine ignores
        # it.
        self.scan_topk = "auto"
        # Counters (the analog of hnswlib's dist_calc, hnswalg.h:58):
        # queries of every search; codes scanned, counted by traced searches.
        self.stats = {"queries": 0, "codes_scanned": 0}

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
        idx._seed_builder(codes, ids, norm_codes, list_offsets)
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

    def _on_device(self, x: torch.Tensor, what: str) -> torch.Tensor:
        """x itself when it is a tensor on this index's device, else
        TypeError / ValueError (the device entry points never copy)."""
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{what} takes a tensor on the index's device "
                            f"({self.device})")
        dev = x.device
        if dev.type != self.device.type or (
                self.device.index is not None and dev.index is not None
                and dev.index != self.device.index):
            raise ValueError(f"{what}: tensor on {dev}, index on "
                             f"{self.device}")
        return x

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
        centroids from an external k-means tool, README.md:56,62);
        hierarchical seeding above 8192 centroids."""
        cents, _ = kmeans(generator, self._tensor(train_data), self.nc,
                          niter=niter, block_c=self._cb())
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

    def load_centroids(self, path: str) -> None:
        """Install the coarse centroids of an ``.fvecs`` file (nc records of
        dimension d)."""
        self.set_centroids(io.read_xvec_fvec(path, self.d, self.nc))

    def compute_centroid_norms(self) -> None:
        """IndexIVF_HNSW.cpp:781-787."""
        self.centroid_norms = (self.centroids * self.centroids).sum(dim=1)

    # ------------------------------------------------------------------
    # Assignment / training
    # ------------------------------------------------------------------

    def enable_fast_assign(self, w: int = 8, n_super: int | None = None,
                           generator: torch.Generator | None = None) -> None:
        """Switch assignment (``assign``, ``add_batch``,
        ``add_batch_device``, ``train_pq``) to the routed two-level assigner
        (``ops.hierarchical.TwoLevelAssigner``): about 1/30 of the exact
        sweep's FLOPs at large nc. Its accuracy depends on clusters of
        centroids: check ``_fast_assigner.exact_match_rate`` on a sample
        before a build adopts it. ``generator`` (default: seed 0 on this
        index's device) draws its super k-means."""
        from ivfhnsw_tpu_torch.ops.hierarchical import TwoLevelAssigner
        if self.centroids is None:
            raise ValueError("set_centroids first")
        self._fast_assigner = TwoLevelAssigner(
            self.centroids, n_super=n_super, w=w, generator=generator)

    def enable_routed_coarse(self, w: int = 16, n_super: int | None = None,
                             cap_factor: float = 1.5,
                             generator: torch.Generator | None = None,
                             cache_path: str | None = None) -> None:
        """Build the search-time routing structure
        (``ops.routed_coarse.RoutedCoarse``): the fused engine selects
        probes among the members of each query's top-``w`` super-clusters
        when ``coarse_mode`` is "routed", or "auto" with nc > 16384. With
        ``cache_path`` an existing ``.npz`` (either package's) is loaded,
        else the structure is built and saved there. Derived data: rebuild
        it after new centroids; measure its probe overlap against exact
        selection before adopting it."""
        from ivfhnsw_tpu_torch.ops.routed_coarse import RoutedCoarse
        if self.centroids is None:
            raise ValueError("set_centroids first")
        if cache_path is not None and os.path.exists(cache_path):
            z = np.load(cache_path)
            self._routed_coarse = RoutedCoarse.from_state(
                self.centroids, z["supers"], z["members"], z["valid"])
        else:
            self._routed_coarse = RoutedCoarse(
                self.centroids, n_super=n_super, cap_factor=cap_factor,
                generator=generator)
            if cache_path is not None:
                self._routed_coarse.save(cache_path)
        self.routed_w = w

    def _cb(self) -> int:
        """Coarse block of the fixed-width sweeps (assignment, training,
        the torch engine): the user's ``coarse_block`` or COARSE_BLOCK."""
        return self.coarse_block or COARSE_BLOCK

    def _assign_t(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-centroid ids [n] int64 of device rows x: the routed
        assigner when enabled, else :meth:`_assign_exact_t`."""
        if self._fast_assigner is not None:
            return self._fast_assigner.assign_tensor(x)
        return self._assign_exact_t(x)

    def _assign_exact_t(self, x: torch.Tensor) -> torch.Tensor:
        """Exact nearest-centroid ids [n] int64 of device rows x, in batches
        that keep each [batch, block] score matrix under ~256 MB."""
        block = self._cb()
        batch = max(1024, min(131072, (1 << 26) // min(block, self.nc)))
        with span("ivf.assign"):
            out = torch.empty(x.shape[0], dtype=torch.int64,
                              device=self.device)
            for off in range(0, x.shape[0], batch):
                _, idx = streaming_topk_l2(x[off:off + batch], self.centroids,
                                           1, block=block,
                                           point_sqnorms=self.centroid_norms)
                out[off:off + batch] = idx[:, 0]
            return out

    def assign(self, x) -> np.ndarray:
        """Nearest-centroid ids for x [n, d] (IndexIVF_HNSW.cpp:68-72), by
        the routed assigner when enabled. Returns int32 [n] on the host."""
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

    def _check_rotation(self) -> None:
        if self.do_opq and self.opq_R is None:
            raise RuntimeError("OPQ index has no rotation: call train_pq "
                               "first")

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        """x @ R.T under OPQ (residuals before PQ, queries before their
        LUTs); x itself otherwise."""
        if not self.do_opq:
            return x
        self._check_rotation()
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
        """Codes of x [n, d] against the centroids of ``keys``
        (:func:`encode_batch`). Returns (codes [n, M] u8, norm_codes [n]
        u8) on the device."""
        self._check_rotation()
        with span("ivf.encode"):
            return encode_batch(x, keys, self.centroids, self.pq.codebooks,
                                self.norm_pq.centroids,
                                self.opq_R if self.do_opq else None)

    def _encode(self, x: torch.Tensor, base: torch.Tensor):
        """residual against ``base`` -> [rotate] -> PQ -> decode ->
        [unrotate] -> reconstruct -> norm code (IndexIVF_HNSW.cpp:87-121).
        Returns (codes [n, M] u8, norm_codes [n] u8)."""
        self._check_rotation()
        return encode_against(x, base, self.pq.codebooks,
                              self.norm_pq.centroids,
                              self.opq_R if self.do_opq else None)

    def add_batch(self, x, xids=None, precomputed_idx=None) -> None:
        """add_batch equivalent (IndexIVF_HNSW.cpp:75-138). Call finalize()
        after the last batch."""
        with span("ivf.add"):
            x = self._tensor(x)
            n = x.shape[0]
            keys = self._keys_for(x, precomputed_idx)
            if xids is None:
                xids = np.arange(self.builder.ntotal, self.builder.ntotal + n,
                                 dtype=np.int32)
            codes, norm_codes = self._encode_batch(x, keys)
            with span("ivf.to_host"):
                self.builder.add(keys.cpu().numpy(), xids,
                                 codes.cpu().numpy(), norm_codes.cpu().numpy())
            self.store = None

    def _device_rows(self, x_dev: torch.Tensor, what: str) -> torch.Tensor:
        """f32 rows of a tensor already on this index's device, for the
        device-resident build."""
        return self._on_device(x_dev, what).to(torch.float32)

    def _assign_device_exact(self, x_dev: torch.Tensor) -> np.ndarray:
        """Exact nearest-centroid ids [n] int32 (host) of rows already on
        this index's device, whether or not the routed assigner is on."""
        x = self._device_rows(x_dev, "_assign_device_exact")
        return self._assign_exact_t(x).cpu().numpy().astype(np.int32)

    def add_batch_device(self, x_dev: torch.Tensor, xids=None) -> None:
        """Device-resident add_batch: x [n, d] is already on this index's
        device, so nothing is uploaded; only the keys, codes and norm codes
        go to the host builder. The same assignment (routed when
        ``enable_fast_assign`` is on) and encoding as ``add_batch`` of the
        same rows, so the store is bit-equal."""
        self.add_batch(self._device_rows(x_dev, "add_batch_device"), xids)

    def add_batch2(self, x, xids, precomputed_idx, eids) -> bytes:
        """add_batch2 equivalent (IndexIVF_HNSW.cpp:140-204): add_batch of x
        under the given centroid ids, returning the ORCV output buffer of
        one record per vector [8B eid | pq_m B PQ code | 1B norm code]."""
        x = self._tensor(x)
        keys = self._keys(precomputed_idx)
        codes, norm_codes = self._encode_batch(x, keys)
        codes_np, norms_np = codes.cpu().numpy(), norm_codes.cpu().numpy()
        self.builder.add(keys.cpu().numpy(), xids, codes_np, norms_np)
        self.store = None
        rec = np.dtype([("eid", "<u8"), ("code", "u1", (self.config.pq_m,)),
                        ("norm", "u1")])
        buf = np.empty(x.shape[0], rec)
        buf["eid"] = np.asarray(eids, np.uint64)
        buf["code"] = codes_np
        buf["norm"] = norms_np
        return buf.tobytes()

    def finalize(self) -> None:
        self.store = self.builder.finalize(self.device)

    def _seed_builder(self, codes, ids, norm_codes, list_offsets) -> None:
        """Replace the builder with one holding a finalized store's flat
        arrays (sorted by list), so that ``add_batch`` + ``finalize``
        extend that store."""
        offsets = np.asarray(list_offsets, np.int64)
        keys = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                         np.diff(offsets))
        self.builder = PostingListBuilder(len(offsets) - 1, self.config.pq_m)
        self.builder.add(keys, ids, codes, norm_codes)

    def reseed_builder_from_store(self) -> None:
        """Rebuild the builder from the store, so that a persisted index
        keeps growing (the reference adds to a read index,
        test_ivfhnsw_grouping_sift1b_vector_add.cpp:262-274). ``read``
        already seeds the builder here; this replaces the builder and never
        adds the store to it a second time."""
        store = self._ensure_store()
        self._seed_builder(store.codes, store.ids, store.norm_codes,
                           store.list_offsets)

    def release_device(self) -> None:
        """Drop the store's device tensors and the routed table built over
        them (the quantizers, centroids and routing structure stay); the
        next device use uploads them again."""
        if self.store is not None:
            self.store.release_device()
        self._routed_table = None

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

    def _resolve_two_phase(self) -> bool:
        """:func:`resolve_two_phase` of ``scan_topk``."""
        return resolve_two_phase(self.scan_topk)

    def _resolve_layout(self) -> str:
        """:func:`resolve_layout` of ``scan_layout`` over this index."""
        return resolve_layout(self.scan_layout, self._ensure_store().ntotal,
                              self.nc)

    def scan_gran(self) -> int:
        """Codes per fused-engine slot under the resolved layout."""
        return fused.RCHUNK if self._resolve_layout() == "quad" else fused.CHUNK

    def _scan_slots(self, params: SearchParams, nprobe: int,
                    gran: int | None = None) -> int:
        """Slot count of the fused engine (the JAX package's _pallas_nch) at
        slot width ``gran`` (default: the resolved layout's): the worst case
        of the max_codes budget, capped by ``params.scan_budget`` (lanes);
        slots beyond the cap drop the farthest probes' tails."""
        mx = self._ensure_store().max_list_size()
        gran = gran or self.scan_gran()
        if params.max_codes and params.max_codes > 0:
            nslots = (params.max_codes + mx) // gran + nprobe + 1
        else:
            nslots = nprobe * max(1, (mx + gran - 1) // gran)
        if params.scan_budget is not None:
            nslots = min(nslots, -(-params.scan_budget // gran))
        return max(nslots, 1)

    def _routed_for(self, params: SearchParams, nprobe: int):
        """The routed coarse arguments of a fused search under ``params``:
        ((supers, super_sqn, table), w) when routing is on, else (None, 0).
        "routed" needs the structure (ValueError otherwise); "auto" adopts
        it when it exists and nc > 16384. ``w`` grows until w * cap covers
        nprobe. The table is built once per store."""
        self._coarse_approx(params)        # an unknown mode raises here
        mode, rc = params.coarse_mode, self._routed_coarse
        if mode == "routed" and rc is None:
            raise ValueError("coarse_mode='routed' requires "
                             "enable_routed_coarse() first")
        if rc is None or mode not in ("routed", "auto") or (
                mode == "auto" and self.nc <= AUTO_ROUTED_NC):
            return None, 0
        w = min(self.routed_w, rc.n_super)
        if w * rc.cap < nprobe:
            w = min(-(-nprobe // rc.cap), rc.n_super)
        store = self._ensure_store()
        cached = self._routed_table
        if cached is None or cached[0] is not rc or cached[1] is not store:
            table = rc.build_table(self.centroid_norms, store.list_offsets_t)
            cached = self._routed_table = (
                rc, store, (rc.supers, rc.super_sqn, table))
        return cached[2], w

    def _coarse_approx(self, params: SearchParams) -> str:
        """Probe selection without routing: "exact" (a full top-k; "auto"
        at every nc, divergence D1), "binned" (the exact 3-pass bin-min)
        or "approx" (``ops.distances.approx_topk_smallest``)."""
        mode = params.coarse_mode
        if mode not in COARSE_MODES:
            raise ValueError(f"unknown coarse_mode {mode!r}; expected one of "
                             f"{'/'.join(COARSE_MODES)}")
        return mode if mode in ("binned", "approx") else "exact"

    def _coarse_for(self, params: SearchParams, nprobe: int) -> dict:
        """The fused engine's coarse arguments under ``params``
        (``ops.cuda.adc_scan.select_probes``' keywords)."""
        routed, rw = self._routed_for(params, nprobe)
        if routed is not None:
            return {"routed": routed, "routed_w": rw}
        mode = self._coarse_approx(params)
        return {"exact_reduce": "binned" if mode == "binned" else "topk",
                "approx": mode == "approx",
                "recall_target": params.coarse_recall}

    def _coarse_block_for(self, B: int) -> int:
        """Coarse sweep block of the fused engine for a batch of B queries:
        the user's ``coarse_block`` as a ceiling, else as wide as a ~64 MB
        [B, block] f32 score block allows (:func:`coarse_block_for`)."""
        return coarse_block_for(self.nc, B, self.coarse_block)

    def _search_torch(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, L: int, trace: bool = False):
        """Portable engine (the JAX ``_search_core``): exact coarse, then
        :meth:`_scan_window`. Like the JAX portable engine it selects
        probes exactly whatever ``coarse_mode`` says."""
        qc_dists, probes = streaming_topk_l2(
            q, self.centroids, nprobe, block=self._cb(),
            point_sqnorms=self.centroid_norms)
        return self._scan_window(q, qc_dists, probes, params.max_codes, L,
                                 params.k, trace)

    def _scan_window(self, q: torch.Tensor, qc_dists: torch.Tensor,
                     probes: torch.Tensor, max_codes: int, L: int, k: int,
                     trace: bool = False):
        """The portable scan over given probes [B, P] (ascending distance
        qc_dists [B, P]): LUTs, the max_codes window of L codes, 3-term
        ADC, top-k. Returns (dists [B, k] f32, labels [B, k] int64, -1
        where the distance is +inf), and with ``trace`` the trace tuple
        (probes, qc_dists, included [B, P] bool, n_scanned [B])."""
        store = self.store
        luts = _pq_ip_luts(self._rotate(q), self.pq.codebooks)
        pos, seg, valid, included = adc_ops.probe_positions(
            probes, store.list_offsets_t, max_codes, L)
        dists, labels = adc_ops.window_scan(
            luts, qc_dists - self.centroid_norms[probes], (pos, seg, valid),
            store, self.norm_pq.centroids, k)
        if trace:
            return (dists, labels,
                    (probes, qc_dists, included, valid.sum(dim=1)))
        return dists, labels

    def _search_fused(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, nslots: int, gran: int, coarse: dict,
                      two_phase: bool):
        """Fused engine: ``ops.cuda.adc_scan.search_core``, as
        :meth:`_fused_inputs` then ``scan_topk``; while tracing, then
        :meth:`_count_scan`."""
        args = self._fused_inputs(q, params, nprobe, nslots, gran, coarse)
        out = fused.scan_topk(args, self.store.ids_t, params.k, gran,
                              two_phase)
        if tracing():
            self._count_scan(args, gran)
        return out

    def _count_scan(self, args: tuple, gran: int) -> None:
        """Add the scan of one batch to ``COUNTERS``, on the device:
        ``scan.lanes`` (B x nslots x gran), ``scan.rows`` (rows in the
        scheduled slots) and ``scan.kept`` (rows no pruning drops: all of
        them here)."""
        with span("ivf.count"):
            start, length = args[4], args[5]
            rows = length.sum()
            COUNTERS.add("scan.lanes", start.numel() * gran)
            COUNTERS.add("scan.rows", rows)
            COUNTERS.add("scan.kept", rows)

    def _fused_inputs(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, nslots: int, gran: int,
                      coarse: dict) -> tuple:
        """``ops.cuda.adc_scan.scan_inputs`` of batch ``q`` over this
        index, with the coarse arguments ``coarse`` (:meth:`_coarse_for`)."""
        store = self.store
        return fused.scan_inputs(
            q, self.centroids, self.centroid_norms, self.pq.codebooks,
            self.norm_pq.centroids, store.codes_t, store.norm_codes_t,
            store.list_offsets_t, params.max_codes, nprobe=nprobe,
            nslots=nslots, gran=gran,
            coarse_block=self._coarse_block_for(q.shape[0]),
            lut_queries=self._rotate(q), **coarse)

    def scan_inputs(self, q: torch.Tensor, params: SearchParams,
                    gran: int | None = None) -> tuple:
        """The fused engine's scan inputs (lut, norm_tab, codes,
        norm_codes, start, length, bias) for batch ``q`` [B, d] on this
        index's device under ``params``, at slot width ``gran`` (default:
        the resolved layout's), as a search of that batch builds them."""
        self._ensure_store()
        nprobe = min(params.nprobe, self.nc)
        gran = gran or self.scan_gran()
        return self._fused_inputs(q, params, nprobe,
                                  self._scan_slots(params, nprobe, gran),
                                  gran, self._coarse_for(params, nprobe))

    def _default_params(self) -> SearchParams:
        return SearchParams(k=10, nprobe=self.nprobe,
                            max_codes=self.max_codes)

    def _searcher(self, params: SearchParams, trace: bool = False):
        """Resolve what a search under ``params`` fixes for every batch
        (engine, coarse mode, slot count and width, top-k), and return the
        per-batch core: fn(q [B, d] f32 on the device) -> (dists [B, k]
        f32, labels [B, k] int64), both on the device. ``trace`` takes the
        torch engine whatever ``engine`` says, and its core also returns
        the trace tuple (probes, qc_dists, included, n_scanned)."""
        with span("ivf.plan"):
            self._ensure_store()
            nprobe = min(params.nprobe, self.nc)
            engine = self._resolve_engine()
            self._coarse_approx(params)        # an unknown mode raises here
            if engine == "torch" or trace:
                L = self._scan_budget(params)
                return lambda q: self._search_torch(q, params, nprobe, L,
                                                    trace)
            nslots, gran = self._scan_slots(params, nprobe), self.scan_gran()
            two_phase = self._resolve_two_phase()
            coarse = self._coarse_for(params, nprobe)
            return lambda q: self._search_fused(q, params, nprobe, nslots,
                                                gran, coarse, two_phase)

    def _search_batches(self, q_all: torch.Tensor, params: SearchParams,
                        batch: int, trace: bool = False):
        """The per-batch core over q_all [N, d], ``batch`` rows at a time;
        (dists [N, k], labels [N, k]) on the device, and with ``trace`` the
        trace tuple over all N queries."""
        core = self._searcher(params, trace)
        out = []
        for off in range(0, q_all.shape[0], batch):
            with span("ivf.chunk"):
                out.append(core(q_all[off:off + batch]))
        res = tuple(torch.cat([o[i] for o in out]) for i in range(2))
        if trace:
            res += (tuple(torch.cat([o[2][i] for o in out])
                          for i in range(4)),)
        return res

    def search(self, queries, params: SearchParams | None = None,
               batch: int = 8192, trace: bool = False):
        """Batched query search, ``batch`` queries per pass. Returns
        (dists [nq, k] f32, labels [nq, k] int64) on the host; label -1
        where fewer than k codes were scanned. (The JAX package caps its
        kernel batch at 1024 for TPU scalar memory; nothing here needs
        that cap.)

        ``trace=True`` (the reference's search_debug,
        IndexIVF_HNSW.cpp:328-391) runs the torch engine and also returns
        a dict of host arrays: "probes" [nq, nprobe] int32 (ascending
        distance), "qc_dists" [nq, nprobe] f32, "included" [nq, nprobe]
        bool (the probes the max_codes budget admits) and "n_scanned" [nq]
        int32 (codes scanned). ``stats["queries"]`` counts every search,
        ``stats["codes_scanned"]`` the codes of traced ones."""
        res = self._search_batches(self._tensor(queries),
                                   params or self._default_params(), batch,
                                   trace)
        d, l = res[0].cpu().numpy(), res[1].cpu().numpy()
        self.stats["queries"] += d.shape[0]
        if not trace:
            return d, l
        probes, qc, inc, nsc = (t.cpu().numpy() for t in res[2])
        self.stats["codes_scanned"] += int(nsc.sum())
        return d, l, {"probes": probes.astype(np.int32), "qc_dists": qc,
                      "included": inc, "n_scanned": nsc.astype(np.int32)}

    def search_device(self, queries: torch.Tensor,
                      params: SearchParams | None = None, batch: int = 8192):
        """Serving path (the JAX ``search_device``): queries already on this
        index's device, [N, d] (searched ``batch`` at a time) or [G, B, d]
        (G batches of B). Returns (dists, labels) on the device, [N, k] or
        [G, B, k] f32 / int64 (-1 where the distance is +inf), with no host
        copy and no synchronisation; :meth:`search` runs the same per-batch
        core. (The JAX package's scalar-memory batch cap and one-launch
        ``lax.map`` are TPU workarounds with no counterpart here.)"""
        with span("ivf.search"):
            self._on_device(queries, "search_device (use search for host "
                            "arrays)")
            if queries.dim() not in (2, 3):
                raise ValueError(f"queries must be [N, d] or [G, B, d], got "
                                 f"shape {tuple(queries.shape)}")
            params = params or self._default_params()
            q = queries.to(torch.float32)
            if q.dim() == 2:
                return self._search_batches(q, params, batch)
            G, B, d = q.shape
            dists, labels = self._search_batches(q.reshape(G * B, d), params,
                                                 B)
            return dists.reshape(G, B, -1), labels.reshape(G, B, -1)

    def scan_slot_demand(self, queries, params: SearchParams,
                         batch: int = 8192) -> np.ndarray:
        """Per-query slot demand [nq] int64 of the fused engine at the
        resolved slot width (the JAX ``scan_slot_demand``): the slots the
        schedule fills under ``params``' nprobe / max_codes rule. Setting
        ``params.scan_budget = max(demand) * scan_gran()`` cuts the slot
        count from the worst case to what these queries use, with the same
        results for every query whose demand is at most that max. The
        probes are those the fused search under ``params`` selects
        (routed, approx, binned or exact), so a profile never
        under-provisions a search whose probes hit larger lists."""
        self._ensure_store()
        nprobe = min(params.nprobe or self.nprobe, self.nc)
        gran = self.scan_gran()
        coarse = self._coarse_for(params, nprobe)
        q_all = self._tensor(queries)
        out = []
        for off in range(0, q_all.shape[0], batch):
            q = q_all[off:off + batch]
            # The fused engine's own coarse step, so that the probes (and
            # the demand) are those its search at this batch size takes.
            probes = fused.select_probes(
                q, self.centroids, self.centroid_norms,
                self.store.list_offsets_t, nprobe=nprobe,
                coarse_block=self._coarse_block_for(q.shape[0]),
                **coarse)[1]
            out.append(self._slot_demand(probes, params, gran))
        return torch.cat(out).cpu().numpy()

    def _slot_demand(self, probes: torch.Tensor, params: SearchParams,
                     gran: int) -> torch.Tensor:
        """Slots each query fills: ceil(list size / gran) for each probe
        the max_codes budget admits (``probe_schedule``'s rule). [B]
        int64."""
        off = self.store.list_offsets_t
        sizes = off[probes + 1] - off[probes]
        inc = probe_budget(sizes, params.max_codes)
        return torch.where(inc, (sizes + gran - 1) // gran, 0).sum(dim=1)

    def search_precomputed(self, queries, probes, qc_dists,
                           params: SearchParams):
        """search2 (IndexIVF_HNSW.h:178; the JAX ``search_precomputed``):
        the portable scan over caller-given probe lists, probes [nq, P]
        centroid ids in ascending distance and qc_dists [nq, P] their
        query-centroid distances, under ``params``' max_codes budget.
        Returns (dists [nq, k] f32, labels [nq, k] int64, -1 where the
        distance is +inf) on the host."""
        self._ensure_store()
        d, l = self._scan_window(
            self._tensor(queries), self._tensor(qc_dists), self._keys(probes),
            params.max_codes, self._scan_budget(params), params.k)
        return d.cpu().numpy(), l.cpu().numpy()

    def search_per_probe(self, queries, params: SearchParams):
        """search2m (IndexIVF_HNSW.cpp:503-531; the JAX
        ``search_per_probe``): an independent top-k within each of the
        nprobe nearest lists, every list scanned whole (the reference's
        budget exit is commented out, :528-530, so max_codes is ignored).
        Returns (dists [nq, nprobe, k] f32, labels [nq, nprobe, k] int64,
        -1 where the distance is +inf) on the host."""
        store = self._ensure_store()
        q = self._tensor(queries)
        nprobe = min(params.nprobe, self.nc)
        qc_dists, probes = streaming_topk_l2(
            q, self.centroids, nprobe, block=self._cb(),
            point_sqnorms=self.centroid_norms)
        B, mx = q.shape[0], max(store.max_list_size(), 1)
        off = store.list_offsets_t
        lane = torch.arange(mx, device=self.device)
        valid = lane < (off[probes + 1] - off[probes])[:, :, None]
        pos = torch.where(valid, off[probes][:, :, None] + lane,
                          0).reshape(B, nprobe * mx)
        bias = ((qc_dists - self.centroid_norms[probes]).repeat_interleave(
            mx, dim=1) + self.norm_pq.centroids[store.norm_codes_t[pos].long()])
        luts = _pq_ip_luts(self._rotate(q), self.pq.codebooks)
        dist = adc_ops.adc_distances(luts, store.codes_t[pos], bias,
                                     valid.reshape(B, nprobe * mx))
        d, sel = topk_smallest(dist.reshape(B, nprobe, mx), params.k)
        labels = torch.gather(store.ids_t[pos].reshape(B, nprobe, mx), 2,
                              sel).long()
        labels = torch.where(torch.isfinite(d), labels, -1)
        return d.cpu().numpy(), labels.cpu().numpy()

    def search_enn(self, x):
        """search_enn (IndexIVF_HNSW.cpp:393-451): the exact self-match
        check, a k=1, nprobe=1 search of stored vectors with no budget.
        Returns (dists [n], labels [n]) on the host."""
        d, l = self.search(x, SearchParams(k=1, nprobe=1, max_codes=0))
        return d[:, 0], l[:, 0]

    # ------------------------------------------------------------------
    # Serialization: the reference's .index format (IndexIVF_HNSW.cpp:
    # 637-669 write / :757-779 read), byte-identical to the JAX package's
    # ``IVFADCIndex.write``:
    # [u64 d | u64 nc | nc x lenvec<u32> ids | nc x lenvec<u8> codes |
    #  nc x lenvec<u8> norm_codes | lenvec<f32> centroid_norms]
    # where lenvec<T> = [u32 count | count*T].
    # ------------------------------------------------------------------

    def write(self, path: str, do_trunc: bool = True) -> None:
        store = self._ensure_store()
        sizes = np.diff(store.list_offsets.astype(np.int64))
        with open(path, "wb" if do_trunc else "ab") as f:
            io.write_variable(f, self.d, "<u8")
            io.write_variable(f, self.nc, "<u8")
            io.write_len_series(f, store.ids.astype("<u4"), sizes)
            io.write_len_series(f, store.codes, sizes * self.config.pq_m)
            io.write_len_series(f, store.norm_codes, sizes)
            io.write_len_vector(
                f, self.centroid_norms.cpu().numpy().astype("<f4"))

    def read(self, path: str) -> None:
        """Load the posting lists of an ``.index`` file whose (d, nc) equal
        this index's config (else ValueError), with their tensors on this
        index's device; the builder is seeded from them, so ``add_batch`` +
        ``finalize`` extend the store. The trailing centroid norms, when the
        file has all nc of them, replace this index's."""
        buf = io.read_file_u8(path)
        d, nc = (int(v) for v in buf[:16].view("<u8"))
        if (d, nc) != (self.d, self.nc):
            raise ValueError(f"index file (d={d}, nc={nc}) != config "
                             f"({self.d}, {self.nc})")
        ids, counts, pos = io.read_len_series(buf, 16, nc, "<u4")
        codes, _, pos = io.read_len_series(buf, pos, nc, "u1")
        norm_codes, _, pos = io.read_len_series(buf, pos, nc, "u1")
        offsets = np.zeros(nc + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        self._seed_builder(codes.reshape(-1, self.config.pq_m),
                           ids.astype(np.int32), norm_codes, offsets)
        self.finalize()
        if buf.size >= pos + 4:
            n_norms = int(buf[pos:pos + 4].view("<u4")[0])
            norms = buf[pos + 4:pos + 4 + 4 * n_norms].view("<f4")
            if norms.size == nc:
                self.centroid_norms = self._tensor(norms.copy())

    def write2(self, home_dir: str, n_vecs: int) -> None:
        """ORCV home-dir export (write2, IndexIVF_HNSW.cpp:672-755), the
        bytes of the JAX package's ``write2``: hdr.vec (``OrcvHeader``),
        cnorms.vec (lenvec of the centroid norms), pq.vec and normpq.vec
        (one lenvec of codes / norm codes per list of the store), opq.vec
        under OPQ (lenvec of the rotated centroids, centroids @ R.T) and an
        empty edge.vec (the reference's graph; no graph here). A grouping
        index writes its nc * nsubc subgroup lists under a header that says
        nc, as the JAX package does."""
        from ivfhnsw_tpu_torch.utils.orcv import OrcvHeader
        os.makedirs(home_dir, exist_ok=True)
        store = self._ensure_store()
        cfg = self.config
        OrcvHeader(n=n_vecs, nc=self.nc, code_size=cfg.code_size,
                   code_bytes=cfg.code_size // 8, d=self.d, M=cfg.M,
                   efConstruction=cfg.efConstruction,
                   do_opq=1 if self.do_opq else 0).write(
                       os.path.join(home_dir, "hdr.vec"))
        with open(os.path.join(home_dir, "cnorms.vec"), "wb") as f:
            io.write_len_vector(
                f, self.centroid_norms.cpu().numpy().astype("<f4"))
        counts = np.diff(store.list_offsets.astype(np.int64))
        with open(os.path.join(home_dir, "pq.vec"), "wb") as f:
            io.write_len_series(f, store.codes, counts * cfg.pq_m)
        with open(os.path.join(home_dir, "normpq.vec"), "wb") as f:
            io.write_len_series(f, store.norm_codes, counts)
        if self.do_opq:
            with open(os.path.join(home_dir, "opq.vec"), "wb") as f:
                rotated = apply_rotation(self.centroids, self.opq_R)
                io.write_len_vector(
                    f, rotated.cpu().numpy().astype("<f4").ravel())
        open(os.path.join(home_dir, "edge.vec"), "wb").close()

    # -- quantizer artifacts ------------------------------------------------

    def save_quantizers(self, path_pq: str, path_norm_pq: str,
                        path_opq: str = "") -> None:
        self.pq.save(path_pq)
        self.norm_pq.save(path_norm_pq)
        if self.do_opq and path_opq:
            save_rotation(path_opq, self.opq_R)

    def load_quantizers(self, path_pq: str, path_norm_pq: str,
                        path_opq: str = "") -> None:
        self.pq = ProductQuantizer.load(path_pq, self.device)
        self.norm_pq = NormQuantizer.load(path_norm_pq, self.device)
        if self.do_opq and path_opq:
            self.opq_R = load_rotation(path_opq, self.device)
