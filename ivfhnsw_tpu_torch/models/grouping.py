"""IVFADC + Grouping (+Pruning) on PyTorch — counterpart of
``ivfhnsw_tpu/models/grouping.py::IVFADCGroupingIndex`` (itself the
equivalent of the reference's ``ivfhnsw::IndexIVF_HNSW_Grouping``).

Each coarse centroid's posting list is split across ``nsubc`` subcentroids
on the segments toward its nsubc nearest neighbour centroids,
``s_j = c + alpha * (n_j - c)`` with one learned alpha per group
(add_group, IndexIVF_HNSW_Grouping.cpp:43-157). Search uses the 4-term
decomposition and the pruning rule of ``ops/grouping.py``.

Build, as the JAX package streams it: neighbour centroids by one matmul
sweep; pass 1 (``alpha_pass``) accumulates per-group alpha statistics with
deterministic segment sums into float64 accumulators on the host; pass 2
(``add_batch``) encodes residuals against each point's subcentroid into
``nc * nsubc`` subgroup lists in (centroid, subc) order.

Search engines:

- ``"torch"`` — the portable gather + top-k path over the subgroup lists,
  counterpart of the JAX ``_grouping_search_core`` and the oracle for the
  fused one;
- ``"fused"`` — ``ops.cuda.grouping_scan`` (``scan_inputs``, then
  ``scan_topk``) with the hand-written grouping scan kernel, counterpart
  of the JAX ``"pallas"`` engine;
- ``"auto"`` — ``"fused"``.

``search`` (with ``trace=True`` on the torch engine, "included" being the
probes the budget over unpruned codes admits) and ``search_device`` run
them through the per-batch core of ``IVFADCIndex``; ``scan_slot_demand``
counts group-granular slots; the device-resident build is
``assign_batch_device``, ``alpha_pass_device`` and ``add_batch_device``;
``search_disk`` reranks 2k candidates against the raw base file on the host.
``write`` / ``read`` take the reference's Grouping ``.index`` format,
byte-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.ivfadc import (COARSE_BLOCK, IVFADCIndex,
                                             _round_up)
from ivfhnsw_tpu_torch.models.storage import PostingListBuilder
from ivfhnsw_tpu_torch.ops import adc as adc_ops
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as fused
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget, query_terms
from ivfhnsw_tpu_torch.ops.pq import _pq_ip_luts
from ivfhnsw_tpu_torch.ops.segment import segment_sum
from ivfhnsw_tpu_torch.utils import io
from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams
from ivfhnsw_tpu_torch.utils.recall import rerank_order

ALPHA_BATCH = 16384  # points per alpha/add sub-batch (JAX alpha_pass default)


def _alpha_stats(x: torch.Tensor, keys: torch.Tensor,
                 centroids: torch.Tensor, nn_idxs: torch.Tensor,
                 nn_dists: torch.Tensor):
    """Pass-1 alpha statistics (compute_alpha, IndexIVF_HNSW_Grouping.cpp:
    691-728): per point, over the nsubc candidate directions, pick the one
    whose per-point-optimal subcentroid is closest to the point, and sum its
    (clamped numerator, denominator) per group.

    x [B, d]; keys [B] centroid ids; nn_idxs, nn_dists [nc, nsubc]
    (nn_dists = ||n - c||^2). Returns (num_sums [nc], den_sums [nc]) f32."""
    c = centroids[keys]                                   # [B, d]
    cv = centroids[nn_idxs[keys]] - c[:, None, :]         # [B, S, d]
    num = torch.bmm(cv, (x - c)[:, :, None])[:, :, 0].clamp_min(0.0)
    den = nn_dists[keys]                                  # [B, S]
    alpha_j = num / den.clamp_min(1e-30)
    s = c[:, None, :] + alpha_j[:, :, None] * cv          # [B, S, d]
    j_star = ((x[:, None, :] - s) ** 2).sum(dim=-1).argmin(dim=1)[:, None]
    stats = torch.cat([num.gather(1, j_star), den.gather(1, j_star)], dim=1)
    sums = segment_sum(stats, keys, centroids.shape[0])
    return sums[:, 0], sums[:, 1]


def _subcentroid_assign(x: torch.Tensor, keys: torch.Tensor,
                        centroids: torch.Tensor, nn_idxs: torch.Tensor,
                        alphas: torch.Tensor):
    """Pass 2: each point's subcentroid with the final group alphas
    (compute_subcentroid_idxs, :673-689). Returns (subc [B] int64,
    subcentroid [B, d] f32)."""
    c = centroids[keys]
    cv = centroids[nn_idxs[keys]] - c[:, None, :]
    s = c[:, None, :] + alphas[keys][:, None, None] * cv  # [B, S, d]
    j = ((x[:, None, :] - s) ** 2).sum(dim=-1).argmin(dim=1)
    return j, s[torch.arange(s.shape[0], device=s.device), j]


def _drop_self(dists: torch.Tensor, idxs: torch.Tensor, rows: torch.Tensor,
               nsubc: int):
    """Of each row's nsubc+1 nearest centroids (dists, idxs [n, nsubc+1],
    ascending), keep the first nsubc columns whose id is not the row's own
    (rows [n, 1]): the self match goes when present, the farthest column
    otherwise (the JAX package's rule, grouping.py:287-294). A stable sort
    on "is self" moves the self column last and keeps the others in order.
    Returns (dists, idxs) [n, nsubc]."""
    keep = torch.sort((idxs == rows).to(torch.int8), dim=1,
                      stable=True).indices[:, :nsubc]
    return dists.gather(1, keep), idxs.gather(1, keep)


class IVFADCGroupingIndex(IVFADCIndex):
    """Grouping variant: per-group subcentroids + alpha + pruning."""

    def __init__(self, config: IndexConfig, device):
        if not 0 < config.nsubc <= 256:
            raise ValueError("grouping index requires 0 < nsubc <= 256 (a "
                             "code's subcentroid index is one byte)")
        super().__init__(config, device)
        self.nsubc = config.nsubc
        # Per-group state (IndexIVF_HNSW_Grouping.h:19-22,61), on device.
        self.nn_centroid_idxs: torch.Tensor | None = None      # [nc, S] i64
        self.inter_centroid_dists: torch.Tensor | None = None  # [nc, S] f32
        self.alphas: torch.Tensor | None = None                # [nc] f32
        self._alpha_num = np.zeros(config.nc, np.float64)
        self._alpha_den = np.zeros(config.nc, np.float64)
        self.do_pruning = False
        # Builder over the flattened (centroid, subc) lists.
        self.builder = PostingListBuilder(config.nc * config.nsubc,
                                          config.pq_m)

    @classmethod
    def from_numpy_state(cls, config: IndexConfig, centroids, codebooks,
                         norm_centroids, codes, ids, norm_codes, list_offsets,
                         nn_centroid_idxs, alphas, inter_centroid_dists,
                         opq_R, device) -> "IVFADCGroupingIndex":
        """Build an index from another grouping index's arrays, given as
        numpy (e.g. ``np.asarray`` of the JAX package's fields): those of
        ``IVFADCIndex.from_numpy_state`` over the nc * nsubc subgroup lists,
        plus nn_centroid_idxs [nc, nsubc], alphas [nc],
        inter_centroid_dists [nc, nsubc] and the OPQ rotation (or None)."""
        idx = super().from_numpy_state(
            config, centroids, codebooks, norm_centroids, codes, ids,
            norm_codes, list_offsets, device, opq_R=opq_R)
        idx.nn_centroid_idxs = torch.tensor(
            np.asarray(nn_centroid_idxs, np.int64), device=idx.device)
        idx.alphas = idx._tensor(alphas)
        idx.inter_centroid_dists = idx._tensor(inter_centroid_dists)
        return idx

    # ------------------------------------------------------------------
    # Serialization: the reference's Grouping .index format
    # (IndexIVF_HNSW_Grouping.cpp:397-483), byte-identical to the JAX
    # package's ``IVFADCGroupingIndex.write``:
    # [u64 d | u64 nc | u64 nsubc | nc x lenvec<u32> ids | nc x lenvec<u8>
    #  codes | nc x lenvec<u8> norm_codes (each group's subgroups
    #  concatenated in subc order) | nc x lenvec<u32> nn_centroid_idxs |
    #  nc x lenvec<u32> subgroup_sizes | lenvec<f32> alphas |
    #  lenvec<f32> centroid_norms | nc x lenvec<f32> inter_centroid_dists]
    # where lenvec<T> = [u32 count | count*T].
    # ------------------------------------------------------------------

    def write(self, path: str, do_trunc: bool = True) -> None:
        """Write the index in the reference's Grouping format. A group's
        subgroups are contiguous in the flat store, so the per-group
        payloads are the flat arrays counted by group."""
        store = self._ensure_store()
        if self.alphas is None or self.nn_centroid_idxs is None:
            raise RuntimeError("grouping index has no alphas or neighbours "
                               "to write: build or read it first")
        sub_sizes = np.diff(store.list_offsets.astype(np.int64)).reshape(
            self.nc, self.nsubc)
        gsizes = sub_sizes.sum(axis=1)
        with open(path, "wb" if do_trunc else "ab") as f:
            io.write_variable(f, self.d, "<u8")
            io.write_variable(f, self.nc, "<u8")
            io.write_variable(f, self.nsubc, "<u8")
            io.write_len_series(f, store.ids.astype("<u4"), gsizes)
            io.write_len_series(f, store.codes, gsizes * self.config.pq_m)
            io.write_len_series(f, store.norm_codes, gsizes)
            io.write_len_rows(
                f, self.nn_centroid_idxs.cpu().numpy().astype("<u4"))
            io.write_len_rows(f, sub_sizes.astype("<u4"))
            io.write_len_vector(f, self.alphas.cpu().numpy().astype("<f4"))
            io.write_len_vector(
                f, self.centroid_norms.cpu().numpy().astype("<f4"))
            io.write_len_rows(
                f, self.inter_centroid_dists.cpu().numpy().astype("<f4"))

    def read(self, path: str) -> None:
        """Load a Grouping ``.index`` file whose (d, nc, nsubc) equal this
        index's config (else ValueError): the subgroup lists, neighbour
        ids, alphas and inter-centroid distances, with their tensors on
        this index's device. The builder is seeded from the lists, so
        ``add_batch`` + ``finalize`` extend the store (the alpha statistics
        are not in the file: alphas learned later start from zero sums).
        The centroid norms, when the file has all nc of them, replace this
        index's."""
        buf = io.read_file_u8(path)
        if buf.size < 24:
            raise ValueError(f"{path}: too short for a grouping index file")
        d, nc, nsubc = (int(v) for v in buf[:24].view("<u8"))
        if (d, nc, nsubc) != (self.d, self.nc, self.nsubc):
            raise ValueError(f"index file (d={d}, nc={nc}, nsubc={nsubc}) != "
                             f"config ({self.d}, {self.nc}, {self.nsubc})")
        ids, _, pos = io.read_len_series(buf, 24, nc, "<u4")
        codes, _, pos = io.read_len_series(buf, pos, nc, "u1")
        norm_codes, _, pos = io.read_len_series(buf, pos, nc, "u1")
        nn, pos = io.read_len_rows(buf, pos, nc, nsubc, "<u4")
        sub_sizes, pos = io.read_len_rows(buf, pos, nc, nsubc, "<u4")
        alphas, _, pos = io.read_len_series(buf, pos, 1, "<f4")
        cnorms, _, pos = io.read_len_series(buf, pos, 1, "<f4")
        icd, pos = io.read_len_rows(buf, pos, nc, nsubc, "<f4")
        offsets = np.zeros(nc * nsubc + 1, np.int64)
        np.cumsum(sub_sizes.astype(np.int64).reshape(-1), out=offsets[1:])
        if offsets[-1] != ids.shape[0]:
            raise ValueError(f"{path}: subgroup sizes sum to {offsets[-1]}, "
                             f"the lists hold {ids.shape[0]} ids")
        self._seed_builder(codes.reshape(-1, self.config.pq_m),
                           ids.astype(np.int32), norm_codes, offsets)
        self.finalize()
        self.nn_centroid_idxs = torch.tensor(nn.astype(np.int64),
                                             device=self.device)
        self.alphas = self._tensor(alphas)
        self.inter_centroid_dists = self._tensor(icd)
        if cnorms.size == nc:
            self.centroid_norms = self._tensor(cnorms)

    def dump_inter_centroid_dists(self, path: str) -> None:
        """Text dump of the centroid-to-neighbour distances
        (IndexIVF_HNSW_Grouping.cpp:633-653), in the reference's wording."""
        icd = self.inter_centroid_dists.cpu().numpy()
        with open(path, "w") as f:
            for i in range(self.nc):
                for subc in range(self.nsubc):
                    f.write(f"distance of centriod {i} to centriod {subc} "
                            f"is {icd[i, subc]:f}\n")

    def scan_inputs(self, q, params, gran=None):
        """Unsupported: the grouping scan takes other inputs, which
        :meth:`grouping_scan_inputs` builds, not IVFADC's."""
        raise NotImplementedError("scan_inputs builds the IVFADC scan's "
                                  "inputs; use grouping_scan_inputs")

    def grouping_scan_inputs(self, q: torch.Tensor, params: SearchParams,
                             gran: int | None = None) -> tuple:
        """The fused engine's scan inputs (lut, norm_tab, t2, codes,
        norm_codes, subc, start, length, bias, seg) for batch ``q`` [B, d]
        on this index's device under ``params``, at slot width ``gran``
        (default: the resolved layout's), as a search of that batch builds
        them."""
        self._ensure_store()
        nprobe = min(params.nprobe, self.nc)
        gran = gran or self.scan_gran()
        return self._fused_inputs(q, params, nprobe,
                                  self._scan_slots(params, nprobe, gran),
                                  gran, self._exact_reduce(params))

    def enable_routed_coarse(self, *args, **kwargs):
        """Unsupported: the grouping engines take exact probe selection
        only, so building the routed structure would be wasted work. Fail
        before that work, not after."""
        raise NotImplementedError(
            "routed coarse selection is not wired into the grouping search "
            "engines; use coarse_mode='exact'")

    # ------------------------------------------------------------------
    # Neighbour-centroid structure
    # ------------------------------------------------------------------

    def compute_neighbor_centroids(self) -> None:
        """Top-nsubc nearest centroids of each centroid (the per-group
        searchKnn(centroid, nsubc+1) at IndexIVF_HNSW_Grouping.cpp:48), as
        one matmul sweep per block of centroids, the self match dropped by
        :func:`_drop_self`. Also fills inter_centroid_dists with the sweep's
        distances."""
        S = self.nsubc
        batch = max(1, 262144 // S)
        nn_d, nn_i = [], []
        for off in range(0, self.nc, batch):
            blk = self.centroids[off:off + batch]
            d_, i_ = streaming_topk_l2(blk, self.centroids, S + 1,
                                       block=COARSE_BLOCK,
                                       point_sqnorms=self.centroid_norms)
            rows = torch.arange(off, off + blk.shape[0],
                                device=self.device)[:, None]
            d_, i_ = _drop_self(d_, i_, rows, S)
            nn_d.append(d_)
            nn_i.append(i_)
        self.nn_centroid_idxs = torch.cat(nn_i)
        self.inter_centroid_dists = torch.cat(nn_d)

    def compute_inter_centroid_dists(self) -> None:
        """||n - c||^2 of each centroid's neighbours, computed directly
        (:620-631); search uses these, while alpha learning used the sweep's
        matmul-form distances (the JAX driver's order)."""
        self._require_neighbors()
        out = []
        for off in range(0, self.nc, 65536):
            c = self.centroids[off:off + 65536]
            n = self.centroids[self.nn_centroid_idxs[off:off + 65536]]
            out.append(((n - c[:, None, :]) ** 2).sum(dim=-1))
        self.inter_centroid_dists = torch.cat(out)

    def _require_neighbors(self) -> None:
        if self.nn_centroid_idxs is None:
            self.compute_neighbor_centroids()

    # ------------------------------------------------------------------
    # Alpha learning + adding (two-pass streaming)
    # ------------------------------------------------------------------

    def alpha_pass(self, x, precomputed_idx=None,
                   batch: int = ALPHA_BATCH) -> None:
        """Pass 1: accumulate per-group alpha numerators and denominators
        over a batch of base vectors (streamable: call for every batch
        before any add_batch)."""
        self._require_neighbors()
        x = self._tensor(x)
        keys = self._keys_for(x, precomputed_idx)
        for off in range(0, x.shape[0], batch):
            num, den = _alpha_stats(x[off:off + batch], keys[off:off + batch],
                                    self.centroids, self.nn_centroid_idxs,
                                    self.inter_centroid_dists)
            self._alpha_num += num.cpu().numpy().astype(np.float64)
            self._alpha_den += den.cpu().numpy().astype(np.float64)

    def finalize_alphas(self) -> None:
        """alpha = group numerator / group denominator (:727); 0 for a group
        that got no point."""
        den = self._alpha_den
        alphas = np.where(den > 0, self._alpha_num / np.maximum(den, 1e-30),
                          0.0)
        self.alphas = self._tensor(alphas.astype(np.float32))

    def add_batch(self, x, xids=None, precomputed_idx=None,
                  batch: int = ALPHA_BATCH) -> None:
        """Pass 2 of add_group (:90-156): subcentroid assignment with the
        final alphas, residual against the subcentroid, [OPQ,] PQ and norm
        codes, bucketed by (centroid, subc). Call finalize() after the last
        batch."""
        if self.alphas is None:
            raise RuntimeError("call alpha_pass(...) on all data then "
                               "finalize_alphas() before add_batch")
        x = self._tensor(x)
        n = x.shape[0]
        keys = self._keys_for(x, precomputed_idx)
        if xids is None:
            xids = np.arange(self.builder.ntotal, self.builder.ntotal + n,
                             dtype=np.int32)
        xids = np.asarray(xids, np.int32)
        for off in range(0, n, batch):
            xb, kb = x[off:off + batch], keys[off:off + batch]
            subc, s_star = _subcentroid_assign(
                xb, kb, self.centroids, self.nn_centroid_idxs, self.alphas)
            codes, norm_codes = self._encode(xb, s_star)
            self.builder.add((kb * self.nsubc + subc).cpu().numpy(),
                             xids[off:off + batch], codes.cpu().numpy(),
                             norm_codes.cpu().numpy())
        self.store = None

    def assign_batch_device(self, x_dev: torch.Tensor) -> np.ndarray:
        """Exact nearest-centroid ids [n] int32 (host) of rows already on
        this index's device, for both passes of a device-resident build."""
        return self._assign_device_exact(x_dev)

    def alpha_pass_device(self, x_dev: torch.Tensor, keys,
                          batch: int = ALPHA_BATCH) -> None:
        """Pass 1 on rows already on this index's device: ``alpha_pass``
        without an upload, so the sums are alpha_pass's over the same
        batches."""
        self.alpha_pass(self._device_rows(x_dev, "alpha_pass_device"), keys,
                        batch)

    def add_batch_device(self, x_dev: torch.Tensor, xids=None,
                         precomputed_idx=None,
                         batch: int = ALPHA_BATCH) -> None:
        """Pass 2 on rows already on this index's device: ``add_batch``
        without an upload, so the store is bit-equal to add_batch's."""
        self.add_batch(self._device_rows(x_dev, "add_batch_device"), xids,
                       precomputed_idx, batch)

    def add(self, x, xids=None, precomputed_idx=None) -> None:
        """Both passes for an in-memory dataset."""
        keys = self._keys_for(self._tensor(x), precomputed_idx)
        self.alpha_pass(x, keys)
        self.finalize_alphas()
        self.add_batch(x, xids, keys)

    def train_pq(self, generator: torch.Generator, train_data,
                 precomputed_idx=None, pq_niter: int = 25,
                 opq_niter: int = 20) -> None:
        """train_pq (IndexIVF_HNSW_Grouping.cpp:486-618): alphas learned on
        the train set alone, then [OPQ +] PQ on the residuals against each
        point's subcentroid and norm-PQ on the reconstructions."""
        self._require_neighbors()
        x = self._tensor(train_data)
        keys = self._keys_for(x, precomputed_idx)
        num, den = _alpha_stats(x, keys, self.centroids,
                                self.nn_centroid_idxs,
                                self.inter_centroid_dists)
        num, den = num.double(), den.double()
        train_alphas = torch.where(den > 0, num / den.clamp_min(1e-30),
                                   0.0).float()
        _, s_star = _subcentroid_assign(x, keys, self.centroids,
                                        self.nn_centroid_idxs, train_alphas)
        self._train_quantizers(generator, x - s_star, s_star, pq_niter,
                               opq_niter)

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _grouped(self):
        return self._ensure_store().grouped(self.nsubc)

    def _scan_budget(self, params: SearchParams) -> int:
        """Padded scan length of the torch engine: budget + the one group
        allowed to cross it, or the nprobe largest groups without a
        budget, rounded to 128."""
        if params.scan_budget is not None:
            return params.scan_budget
        gsizes = self._grouped().group_sizes
        if params.max_codes and params.max_codes > 0:
            budget = params.max_codes + int(gsizes.max(initial=0))
        else:
            budget = int(np.sort(gsizes)[-min(params.nprobe,
                                              self.nc):].sum())
        return _round_up(max(budget, 128), 128)

    def _scan_slots(self, params: SearchParams, nprobe: int,
                    gran: int | None = None) -> int:
        """Slot count of the fused engine at slot width ``gran`` (default:
        the resolved layout's). A probe's whole group takes slots
        while the budget counts unpruned codes, so under pruning many probes
        can each demand their full group: the exact worst case is the slots
        of the nprobe largest groups. Without pruning the budget also bounds
        it by (max_codes + largest group) / gran + nprobe + 1. Capped by
        ``params.scan_budget`` (lanes), which drops the farthest probes'
        tails."""
        gran = gran or self.scan_gran()
        gsizes = self._grouped().group_sizes
        slots = -(-gsizes // gran)
        nslots = int(np.sort(slots)[-min(nprobe, slots.size):].sum())
        if params.max_codes and params.max_codes > 0 and not params.do_pruning:
            nslots = min(nslots, (params.max_codes + int(gsizes.max())) // gran
                         + nprobe + 1)
        if params.scan_budget is not None:
            nslots = min(nslots, -(-params.scan_budget // gran))
        return max(nslots, 1)

    def _search_torch(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, L: int, trace: bool = False):
        """Portable engine (the JAX ``_grouping_search_core``): the scan
        window over the scanned subgroups of the budgeted probes, 4-term
        ADC, top-k; with ``trace`` also (probes, qc_dists, included,
        n_scanned), "included" the probes the budget admits."""
        store, gv = self.store, self._grouped()
        qc_dists, probes = streaming_topk_l2(
            q, self.centroids, nprobe, block=COARSE_BLOCK,
            point_sqnorms=self.centroid_norms)
        term1, term2, scan, ssz = query_terms(
            q, qc_dists, probes, self.centroids, self.centroid_norms,
            self.nn_centroid_idxs, self.alphas, self.inter_centroid_dists,
            gv.sub_sizes_t, params.max_codes, params.do_pruning)
        eff = torch.where(scan, ssz, 0)                           # [B, P, S]
        inc = probe_budget(eff.sum(dim=2), params.max_codes)
        B = q.shape[0]
        slot_ids = (probes[:, :, None] * self.nsubc
                    + torch.arange(self.nsubc, device=self.device))
        pos, seg, valid = adc_ops.window_positions(
            slot_ids.reshape(B, -1), (eff * inc[:, :, None]).reshape(B, -1),
            store.list_offsets_t, L)
        slot_bias = (term1[:, :, None] + term2).reshape(B, -1)
        bias = (torch.gather(slot_bias, 1, seg)
                + self.norm_pq.centroids[store.norm_codes_t[pos].long()])
        luts = _pq_ip_luts(self._rotate(q), self.pq.codebooks)
        dists, sel = adc_ops.adc_scan(luts, store.codes_t[pos], bias, valid,
                                      params.k)
        labels = torch.gather(store.ids_t[pos], 1, sel).long()
        out = dists, torch.where(torch.isfinite(dists), labels, -1)
        if trace:
            return (*out, (probes, qc_dists, inc, valid.sum(dim=1)))
        return out

    def _search_fused(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, nslots: int, gran: int,
                      exact_reduce: str, two_phase: bool):
        """Fused engine: :meth:`_fused_inputs`, then
        ``ops.cuda.grouping_scan.scan_topk`` (wide top-k only: the JAX
        grouping engine has no two-phase top-k)."""
        if two_phase:
            raise NotImplementedError("the grouping engines have no "
                                      "two-phase top-k; use scan_topk='auto'")
        args = self._fused_inputs(q, params, nprobe, nslots, gran,
                                  exact_reduce)
        return fused.scan_topk(args, self.store.ids_t, params.k, gran)

    def _fused_inputs(self, q: torch.Tensor, params: SearchParams,
                      nprobe: int, nslots: int, gran: int,
                      exact_reduce: str) -> tuple:
        """``ops.cuda.grouping_scan.scan_inputs`` of batch ``q`` over this
        index."""
        store, gv = self.store, self._grouped()
        return fused.scan_inputs(
            q, self.centroids, self.centroid_norms, self.pq.codebooks,
            self.norm_pq.centroids, store.codes_t, store.norm_codes_t,
            gv.subc_t, gv.group_offsets_t, gv.sub_sizes_t,
            self.nn_centroid_idxs, self.alphas, self.inter_centroid_dists,
            params.max_codes, nprobe=nprobe, nslots=nslots, gran=gran,
            coarse_block=self._coarse_block_for(q.shape[0]),
            do_pruning=params.do_pruning, exact_reduce=exact_reduce,
            lut_queries=self._rotate(q))

    def search_disk(self, queries, params: SearchParams,
                    base_file: io.XvecFile):
        """searchDisk (IndexIVF_HNSW_Grouping.cpp:365-395): an ANN search
        for 2k candidates, then an exact L2 rerank against the raw base
        file with the distance-then-label tiebreak
        (``utils.recall.rerank_order``). The candidates' rows are gathered
        from the file and reranked on the host, query by query, as the
        reference does; only the ANN search runs on the index's device.
        Returns (dists [nq, k] f32, labels [nq, k] int64) on the host,
        padded with (+inf, -1) where fewer than k candidates were found."""
        p2 = SearchParams(k=2 * params.k, nprobe=params.nprobe,
                          max_codes=params.max_codes,
                          do_pruning=params.do_pruning,
                          scan_budget=params.scan_budget)
        _, cand = self.search(queries, p2)
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        out_d = np.full((nq, params.k), np.inf, np.float32)
        out_l = np.full((nq, params.k), -1, np.int64)
        for i in range(nq):
            labels = cand[i][cand[i] >= 0]
            vecs = base_file.gather(labels)
            exact = ((vecs - queries[i][None]) ** 2).sum(1)
            dd, ll = rerank_order(exact, labels)
            n = min(params.k, dd.shape[0])
            out_d[i, :n] = dd[:n]
            out_l[i, :n] = ll[:n]
        return out_d, out_l

    def _default_params(self) -> SearchParams:
        return SearchParams(k=10, nprobe=self.nprobe,
                            max_codes=self.max_codes,
                            do_pruning=self.do_pruning)

    def _searcher(self, params: SearchParams, trace: bool = False):
        """As ``IVFADCIndex._searcher`` (so ``search`` and ``search_device``
        run it), with ``params.do_pruning`` (default ``self.do_pruning``)
        selecting subgroup pruning."""
        if params.coarse_mode == "routed":
            raise NotImplementedError(
                "coarse_mode='routed' is not wired into the grouping search "
                "engines; use 'exact'")
        if self.alphas is None or self.nn_centroid_idxs is None:
            raise RuntimeError("grouping index has no alphas or neighbours: "
                               "build it (alpha_pass, finalize_alphas, "
                               "add_batch) first")
        return super()._searcher(params, trace)

    def _slot_demand(self, probes: torch.Tensor, params: SearchParams,
                     gran: int) -> torch.Tensor:
        """Slots of each query's probed groups (the JAX grouping
        ``scan_slot_demand``): ceil(group size / gran) per probe. Without
        pruning the max_codes budget on full group sizes gates the probes,
        exactly as ``grouping_schedule``; under pruning the budget counts
        unpruned codes, which the demand does not know, so every probed
        group counts (an upper bound that never truncates)."""
        off = self._grouped().group_offsets_t
        sizes = off[probes + 1] - off[probes]
        inc = probe_budget(sizes, 0 if params.do_pruning else params.max_codes)
        return torch.where(inc, (sizes + gran - 1) // gran, 0).sum(dim=1)
