"""Sharded IVFADC search over a shard group. Counterpart of
``ivfhnsw_tpu/parallel/sharded.py``.

Shard s of a group of D owns the global centroids [s * nc_loc,
(s + 1) * nc_loc) and the flat store rows of their lists, rebased to its
own offsets: each shard's arrays are its own tensors on its device, with
no padding to the largest shard (the JAX package pads for ``shard_map``'s
uniform shapes) and no TPU tile mirror. A search batch runs the step

1. each shard: an exact top-``min(nprobe, nc_loc)`` over its centroid
   block (the same sweep as the single index, TF32 off);
2. ``all_gather`` of the candidates and a merge into the global
   top-``nprobe``, ascending, the same on every shard;
3. ``psum`` of the probes' list sizes and centroid norms over their
   owners, so ``max_codes`` has the single-index meaning (a probe is
   included iff the codes of the probes before it number fewer than
   max_codes);
4. each shard: a scan of its owned, included probes, engine "torch" (the
   portable window scan) or "fused" (the single index's slot schedule,
   LUTs and ``ops.cuda.adc_scan.scan_topk``: the scan kernel, or the
   min-scan kernel and a rescan under the two-phase top-k);
5. ``all_gather`` of the shards' top-k and a merge,

written once over :mod:`.mesh`'s group interface, so it runs the same
under ``LocalShards`` and ``DistributedShards``. Each shard sizes its
scan from its own demand: the most slots (fused) or codes (torch) any
query of the batch needs from that shard after the budget step, at one
host sync per shard. Coarse selection is exact: ``coarse_mode`` "auto" or
"exact" only. The result equals ``IVFADCIndex.search`` with exact coarse
selection up to f32 ties (D3/D4 of ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.ivfadc import (coarse_block_for,
                                             resolve_layout,
                                             resolve_two_phase)
from ivfhnsw_tpu_torch.models.storage import PostingListStore
from ivfhnsw_tpu_torch.ops.adc import window_positions, window_scan
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as fused
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget
from ivfhnsw_tpu_torch.ops.opq import apply_rotation
from ivfhnsw_tpu_torch.ops.pq import _pq_ip_luts
from ivfhnsw_tpu_torch.ops.topk import topk_smallest
from ivfhnsw_tpu_torch.utils.config import SearchParams

ENGINES = ("auto", "torch", "fused")


def put(x, device, dtype=None) -> torch.Tensor:
    """A tensor of ``x`` (numpy or tensor) on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def resolve_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{'/'.join(ENGINES)}")
    return "fused" if engine == "auto" else engine


def check_coarse(params: SearchParams) -> None:
    if params.coarse_mode not in ("auto", "exact"):
        raise ValueError(f"coarse_mode {params.coarse_mode!r}: the sharded "
                         "search selects probes exactly ('auto' or 'exact')")


def empty_result(B: int, k: int, device):
    return (torch.full((B, k), float("inf"), device=device),
            torch.full((B, k), -1, dtype=torch.int64, device=device))


def demand(included: torch.Tensor, sizes: torch.Tensor, gran: int) -> int:
    """The most slots of ``gran`` codes any query needs for its included
    lists (one host sync)."""
    need = torch.where(included, (sizes + gran - 1) // gran, 0).sum(dim=1)
    return int(need.max()) if need.numel() else 0


def window_len(sizes: torch.Tensor, scan_budget) -> int:
    """The torch engine's window: the most codes any query scans, rounded
    up to 128 (0 when none does), capped by ``scan_budget``."""
    n = int(sizes.sum(dim=1).max()) if sizes.numel() else 0
    n = -(-n // 128) * 128
    return n if scan_budget is None else min(n, scan_budget)


class Shard:
    """One shard's share of an index on ``device``: the centroid rows it
    holds (``centroids``, ``centroid_norms``; global ids from
    ``table_lo``), of which it owns the nc_loc from ``lo``, its store, and
    the replicated quantizers."""

    def __init__(self, rank: int, device, lo: int, nc_loc: int, centroids,
                 centroid_norms, store: PostingListStore, codebooks,
                 norm_centroids, R, table_lo: int):
        self.rank, self.device, self.lo, self.nc_loc = rank, device, lo, nc_loc
        self.centroids = put(centroids, device, torch.float32).contiguous()
        self.centroid_norms = put(centroid_norms, device, torch.float32)
        rows = slice(lo - table_lo, lo - table_lo + nc_loc)
        self.block, self.block_norms = (self.centroids[rows],
                                        self.centroid_norms[rows])
        self.store = store
        self.codebooks = put(codebooks, device, torch.float32)
        self.norm_centroids = put(norm_centroids, device, torch.float32)
        self.R = None if R is None else put(R, device, torch.float32)

    def coarse(self, q: torch.Tensor, nprobe: int, block: int):
        """Step 1: the exact top-min(nprobe, nc_loc) of this shard's
        centroid block, as global ids. ([B, np_loc] f32, [B, np_loc]
        int64)."""
        d, i = streaming_topk_l2(q.to(self.device), self.block,
                                 min(nprobe, self.nc_loc), block=block,
                                 point_sqnorms=self.block_norms)
        return d, i + self.lo

    def own(self, probes: torch.Tensor):
        """(own [B, P] bool — probes this shard owns, lp [B, P] int64 —
        their local ids, 0 elsewhere) of global probes on its device."""
        probes = probes.to(self.device)
        own = (probes >= self.lo) & (probes < self.lo + self.nc_loc)
        return own, torch.where(own, probes - self.lo, 0)

    def rotated(self, q: torch.Tensor) -> torch.Tensor:
        q = q.to(self.device)
        return q if self.R is None else apply_rotation(q, self.R)


class IVFShard(Shard):
    """A shard of an IVFADC index (its store holds nc_loc lists)."""

    def probe_terms(self, probes: torch.Tensor):
        """Step 3's parts: the sizes [B, P] int64 and centroid norms [B, P]
        f32 of the probes this shard owns, 0 elsewhere."""
        own, lp = self.own(probes)
        off = self.store.list_offsets_t
        return (torch.where(own, off[lp + 1] - off[lp], 0),
                torch.where(own, self.centroid_norms[lp], 0.0))

    def schedule(self, probes, included, term1, gran: int, scan_budget):
        """The fused engine's slot schedule of this shard's owned, included
        probes: (start, length, bias) of ``nslots`` = its demand (capped
        by ``scan_budget`` lanes), or None when it scans nothing."""
        own, lp = self.own(probes)
        off = self.store.list_offsets_t
        lo = off[lp]
        sizes = torch.where(own, off[lp + 1] - lo, 0)
        inc = included.to(self.device) & own
        nslots = demand(inc, sizes, gran)
        if scan_budget is not None:
            nslots = min(nslots, -(-scan_budget // gran))
        if nslots == 0:
            return None
        start, length, bias, _ = fused.slot_schedule(
            lo, sizes, inc, term1.to(self.device), nslots, gran)
        return start, length, bias

    def scan_args(self, q, probes, included, term1, gran: int, scan_budget):
        """:meth:`schedule` with the LUTs: the scan kernels' arguments
        (lut, norm_tab, codes, norm_codes, start, length, bias), or None."""
        sched = self.schedule(probes, included, term1, gran, scan_budget)
        if sched is None:
            return None
        st = self.store
        return (fused.build_luts(self.rotated(q), self.codebooks),
                self.norm_centroids, st.codes_t, st.norm_codes_t, *sched)

    def scan(self, q, probes, included, term1, k: int, engine: str,
             gran: int, two_phase: bool, scan_budget):
        """Step 4: this shard's top-k ([B, k] f32, [B, k] int64 global ids,
        -1 where +inf) and the slots (fused) or codes (torch) it used."""
        if engine == "fused":
            args = self.scan_args(q, probes, included, term1, gran,
                                  scan_budget)
            if args is None:
                return (*empty_result(q.shape[0], k, self.device), 0)
            d, l = fused.scan_topk(args, self.store.ids_t, k, gran,
                                   two_phase)
            return d, l, args[4].shape[1]
        own, lp = self.own(probes)
        off = self.store.list_offsets_t
        eff = torch.where(included.to(self.device) & own,
                          off[lp + 1] - off[lp], 0)
        L = window_len(eff, scan_budget)
        if L == 0:
            return (*empty_result(q.shape[0], k, self.device), 0)
        d, l = window_scan(_pq_ip_luts(self.rotated(q), self.codebooks),
                           term1.to(self.device),
                           window_positions(lp, eff, off, L), self.store,
                           self.norm_centroids, k)
        return d, l, L


def global_probes(group, shards, q: torch.Tensor, nprobe: int):
    """Steps 1-2: every shard's local coarse top-k, gathered and merged
    into the global top-``nprobe`` (qc_dists f32, probes int64, [B, P],
    ascending) on the group's home device."""
    block = coarse_block_for(shards[0].nc_loc, q.shape[0])
    parts = [sh.coarse(q, nprobe, block) for sh in shards]
    cat_d = group.all_gather([p[0] for p in parts], dim=1)
    cat_i = group.all_gather([p[1] for p in parts], dim=1)
    qc, sel = topk_smallest(cat_d, nprobe)
    return qc, torch.gather(cat_i, 1, sel)


def merge_results(group, parts, k: int):
    """Step 5: the shards' top-k gathered and merged, on the home
    device."""
    d = group.all_gather([p[0] for p in parts], dim=1)
    lab = group.all_gather([p[1] for p in parts], dim=1)
    best, sel = topk_smallest(d, k)
    return best, torch.gather(lab, 1, sel)


def split_store(store: PostingListStore, nlists: int, s: int, device):
    """Shard s's part of ``store``: its ``nlists`` consecutive lists from
    list s * nlists, offsets rebased to its first row; host arrays are
    views, device tensors are uploaded on first use."""
    off = store.list_offsets.astype(np.int64)
    first, last = off[s * nlists], off[(s + 1) * nlists]
    return PostingListStore(
        codes=store.codes[first:last], ids=store.ids[first:last],
        norm_codes=store.norm_codes[first:last],
        list_offsets=off[s * nlists:(s + 1) * nlists + 1] - first,
        nc=nlists, device=device)


class ShardedSearch:
    """What the sharded indexes share: the slot width and ``search``
    around their ``_step`` (one query batch on the home device ->
    (dists, labels) there)."""

    def scan_gran(self) -> int:
        """Codes per fused-engine slot under the resolved layout (the
        average list over the whole index)."""
        layout = resolve_layout(self.scan_layout, self.ntotal, self.nc)
        return fused.RCHUNK if layout == "quad" else fused.CHUNK

    def search(self, queries, params: SearchParams, engine: str = "auto",
               batch: int = 8192):
        """(dists [nq, k] f32, labels [nq, k] int64, -1 where +inf) on the
        host for host queries [nq, d], ``batch`` at a time. engine "auto"
        (= "fused"), "fused" or "torch". ``last_slots`` maps each served
        shard to the slots (fused) or window codes (torch) of its last
        batch."""
        engine = resolve_engine(engine)
        q_all = put(np.asarray(queries, np.float32), self.group.home)
        out = [self._step(q_all[o:o + batch], params, engine)
               for o in range(0, q_all.shape[0], batch)]
        return (torch.cat([o[0] for o in out]).cpu().numpy(),
                torch.cat([o[1] for o in out]).cpu().numpy())


class ShardedIVFADC(ShardedSearch):
    """A finalized ``IVFADCIndex`` laid out over a shard group (see the
    module docstring). ``scan_layout`` and ``scan_topk`` start as the
    index's and resolve as its do, over the whole index."""

    def __init__(self, index, group):
        store = index._ensure_store()
        nc_loc = self._nc_loc(index.nc, group)
        cents = index.centroids.cpu().numpy()
        norms = index.centroid_norms.cpu().numpy()
        shards = {}
        for s in group.ranks:
            rows = slice(s * nc_loc, (s + 1) * nc_loc)
            shards[s] = (cents[rows], norms[rows],
                         split_store(store, nc_loc, s, group.device(s)))
        self._setup(group, nc_loc, shards, index.pq.codebooks,
                    index.norm_pq.centroids,
                    index.opq_R if index.do_opq else None)
        self.scan_layout, self.scan_topk = index.scan_layout, index.scan_topk

    @staticmethod
    def _nc_loc(nc: int, group) -> int:
        if nc % group.size:
            raise ValueError(f"nc={nc} must divide evenly over {group.size} "
                             "shards (pad nc or choose another group)")
        return nc // group.size

    @classmethod
    def from_arrays(cls, group, nc_loc: int, shards: dict, codebooks,
                    norm_centroids, R=None) -> "ShardedIVFADC":
        """The sharded index of per-shard arrays: ``shards[s]`` =
        (centroids [nc_loc, d], centroid_norms [nc_loc], its
        PostingListStore) for every s in ``group.ranks``; codebooks
        [M, 256, dsub], norm_centroids [256] and the OPQ rotation R [d, d]
        (None without OPQ) replicated. Layout and top-k "auto"."""
        self = cls.__new__(cls)
        self._setup(group, nc_loc, shards, codebooks, norm_centroids, R)
        self.scan_layout = self.scan_topk = "auto"
        return self

    def _setup(self, group, nc_loc, shards, codebooks, norm_centroids, R):
        self.group, self.nc_loc = group, nc_loc
        self.nc = nc_loc * group.size
        self.do_opq = R is not None
        self.shards = [
            IVFShard(s, group.device(s), s * nc_loc, nc_loc, *shards[s],
                     codebooks, norm_centroids, R, s * nc_loc)
            for s in group.ranks]
        for sh in self.shards:
            if sh.store.nc != nc_loc or sh.store.device != sh.device:
                raise ValueError(f"shard {sh.rank}: a store of {sh.store.nc} "
                                 f"lists on {sh.store.device}, expected "
                                 f"{nc_loc} on {sh.device}")
        self.ntotal = int(group.psum([
            torch.tensor([sh.store.ntotal], device=sh.device)
            for sh in self.shards]).item())
        self.last_slots: dict = {}

    def _probes(self, q: torch.Tensor, params: SearchParams):
        """Steps 1-3: (probes, included, term1) [B, P] on the home
        device."""
        check_coarse(params)
        nprobe = min(params.nprobe, self.nc)
        qc, probes = global_probes(self.group, self.shards, q, nprobe)
        parts = [sh.probe_terms(probes) for sh in self.shards]
        sizes = self.group.psum([p[0] for p in parts])
        norms = self.group.psum([p[1] for p in parts])
        return probes, probe_budget(sizes, params.max_codes), qc - norms

    def _step(self, q: torch.Tensor, params: SearchParams, engine: str):
        probes, included, term1 = self._probes(q, params)
        gran = self.scan_gran()
        two_phase = resolve_two_phase(self.scan_topk)
        parts = [sh.scan(q, probes, included, term1, params.k, engine, gran,
                         two_phase, params.scan_budget)
                 for sh in self.shards]
        for sh, p in zip(self.shards, parts):
            self.last_slots[sh.rank] = p[2]
        return merge_results(self.group, parts, params.k)

    def scan_inputs(self, queries, params: SearchParams, rank: int):
        """Shard ``rank``'s scan kernel arguments (lut, norm_tab, codes,
        norm_codes, start, length, bias) for host queries [B, d] under
        ``params`` at the resolved slot width, as its fused search builds
        them (None when it scans nothing). Runs the collectives, so every
        rank of a distributed group calls it."""
        q = put(np.asarray(queries, np.float32), self.group.home)
        probes, included, term1 = self._probes(q, params)
        sh = self.shards[self.group.ranks.index(rank)]
        return sh.scan_args(q, probes, included, term1, self.scan_gran(),
                            params.scan_budget)
