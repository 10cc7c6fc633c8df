"""Sharded Grouping(+Pruning) search over a shard group. Counterpart of
``ivfhnsw_tpu/parallel/sharded_grouping.py``.

Groups (coarse centroids) are sharded by contiguous ranges as in
:mod:`.sharded`: shard s holds the nc_loc * nsubc subgroup lists of its
groups and their state (neighbour ids, alphas, inter-centroid distances);
the centroid table is replicated (neighbour distances reference any row),
but each shard sweeps only its own block. The step, written once over the
group interface of :mod:`.mesh`:

1. local coarse top-k, ``all_gather``, global merge (``sharded.
   global_probes``);
2. each shard: the grouping terms of the probes it owns
   (``ops.grouping.group_terms``); ``psum`` of the group sizes;
3. with pruning: each shard's part of the threshold
   (``ops.grouping.pruning_sums``) and ``psum`` of sums and counts, so the
   threshold is the mean over all scanned subgroups
   (IndexIVF_HNSW_Grouping.cpp:261), not a per-shard mean; its f32 sum is
   taken in shard order, so a subgroup at the threshold may flip against
   the single index;
4. ``psum`` of the unpruned codes per probe, the budget over them;
5. each shard: engine "torch" (the portable window scan over its scanned
   subgroups) or "fused" (the group-granular slot schedule and
   ``ops.cuda.grouping_scan.scan_topk``, the grouping scan kernel), slots
   sized from its own demand; ``all_gather`` of the top-k and a merge.
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.adc import window_positions, window_scan
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as fused
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as gfused
from ivfhnsw_tpu_torch.ops.grouping import (group_terms, probe_budget, prune,
                                            pruning_sums, subgroup_windows)
from ivfhnsw_tpu_torch.ops.pq import _pq_ip_luts
from ivfhnsw_tpu_torch.parallel.sharded import (ShardedIVFADC, ShardedSearch,
                                                Shard, check_coarse, demand,
                                                empty_result, global_probes,
                                                merge_results, put,
                                                split_store, window_len)
from ivfhnsw_tpu_torch.utils.config import SearchParams


class GroupingShard(Shard):
    """A shard of a grouping index: the replicated centroid table, its
    groups' state and their nc_loc * nsubc subgroup lists."""

    def __init__(self, rank, device, lo, nc_loc, centroids, centroid_norms,
                 store, codebooks, norm_centroids, R, nn_idxs, alphas,
                 inter_dists):
        super().__init__(rank, device, lo, nc_loc, centroids, centroid_norms,
                         store, codebooks, norm_centroids, R, 0)
        self.nn_idxs = put(nn_idxs, device, torch.int64)
        self.alphas = put(alphas, device, torch.float32)
        self.inter_dists = put(inter_dists, device, torch.float32)
        self.nsubc = self.nn_idxs.shape[1]
        self.grouped = store.grouped(self.nsubc)

    def terms(self, q, qc, probes, with_qsd: bool):
        """Step 2: (own, lp, term1, term2, qsd, ssz) of the global probes,
        ssz 0 on the probes another shard owns."""
        own, lp = self.own(probes)
        term1, term2, qsd, ssz = group_terms(
            q.to(self.device), qc.to(self.device), probes.to(self.device),
            self.centroids, self.centroid_norms, self.nn_idxs, self.alphas,
            self.inter_dists, self.grouped.sub_sizes_t, with_qsd, groups=lp)
        return own, lp, term1, term2, qsd, torch.where(own[:, :, None], ssz,
                                                       0)

    def scan_args(self, q, terms, scan, eff, max_codes: int, gran: int,
                  scan_budget):
        """The grouping scan kernel's arguments (lut, norm_tab, t2, codes,
        norm_codes, subc, start, length, bias, seg) of this shard: its
        included probes' whole groups in slots, the budget over the
        group's unpruned codes ``eff`` [B, P]; None when it scans
        nothing."""
        _, lp, term1, term2, _, ssz = terms
        own_eff = torch.where(scan, ssz, 0).sum(dim=2)
        gsz = ssz.sum(dim=2)
        inc = probe_budget(eff.to(self.device), max_codes) & (own_eff > 0)
        nslots = demand(inc, gsz, gran)
        if scan_budget is not None:
            nslots = min(nslots, -(-scan_budget // gran))
        if nslots == 0:
            return None
        start, length, bias, seg = fused.slot_schedule(
            self.grouped.group_offsets_t[lp], gsz, inc, term1, nslots, gran)
        st = self.store
        return (fused.build_luts(self.rotated(q), self.codebooks),
                self.norm_centroids,
                torch.where(scan, term2, float("inf")), st.codes_t,
                st.norm_codes_t, self.grouped.subc_t, start, length, bias,
                seg)

    def scan(self, q, terms, scan, eff, params: SearchParams, engine: str,
             gran: int):
        """Step 5: this shard's top-k and the slots (fused) or window
        codes (torch) it used."""
        B, k = q.shape[0], params.k
        if engine == "fused":
            args = self.scan_args(q, terms, scan, eff, params.max_codes,
                                  gran, params.scan_budget)
            if args is None:
                return (*empty_result(B, k, self.device), 0)
            d, l = gfused.scan_topk(args, self.store.ids_t, k, gran)
            return d, l, args[6].shape[1]
        _, lp, term1, term2, _, ssz = terms
        lists, sizes, _ = subgroup_windows(scan, ssz, lp, eff.to(self.device),
                                           params.max_codes)
        L = window_len(sizes, params.scan_budget)
        if L == 0:
            return (*empty_result(B, k, self.device), 0)
        d, l = window_scan(_pq_ip_luts(self.rotated(q), self.codebooks),
                           (term1[:, :, None] + term2).reshape(B, -1),
                           window_positions(lists, sizes,
                                            self.store.list_offsets_t, L),
                           self.store, self.norm_centroids, k)
        return d, l, L


class ShardedGrouping(ShardedSearch):
    """A finalized ``IVFADCGroupingIndex`` laid out over a shard group
    (see the module docstring); ``scan_layout`` starts as the index's.
    The grouping engines have no two-phase top-k; ``params.do_pruning``
    selects subgroup pruning."""

    def __init__(self, index, group):
        store = index._ensure_store()
        nc_loc = ShardedIVFADC._nc_loc(index.nc, group)
        self.group, self.nc_loc, self.nc = group, nc_loc, index.nc
        self.nsubc = index.nsubc
        self.ntotal = store.ntotal
        self.scan_layout = index.scan_layout
        self.last_slots: dict = {}
        self.shards = []
        for s in group.ranks:
            dev, rows = group.device(s), slice(s * nc_loc, (s + 1) * nc_loc)
            self.shards.append(GroupingShard(
                s, dev, s * nc_loc, nc_loc, index.centroids,
                index.centroid_norms,
                split_store(store, nc_loc * self.nsubc, s, dev),
                index.pq.codebooks, index.norm_pq.centroids,
                index.opq_R if index.do_opq else None,
                index.nn_centroid_idxs[rows], index.alphas[rows],
                index.inter_centroid_dists[rows]))

    def _terms(self, q: torch.Tensor, params: SearchParams):
        """Steps 1-4: each shard's terms and scanned subgroups, and the
        probes' unpruned codes over the group [B, P] (home device)."""
        check_coarse(params)
        g = self.group
        qc, probes = global_probes(g, self.shards, q,
                                   min(params.nprobe, self.nc))
        terms = [sh.terms(q, qc, probes, params.do_pruning)
                 for sh in self.shards]
        if params.do_pruning:
            g_sizes = g.psum([t[5].sum(dim=2) for t in terms])
            parts = [pruning_sums(t[4], t[5], g_sizes.to(sh.device),
                                  params.max_codes)
                     for sh, t in zip(self.shards, terms)]
            total = g.psum([p[0] for p in parts])
            count = g.psum([p[1] for p in parts])
            scans = [prune(t[4], t[5], total.to(sh.device),
                           count.to(sh.device))
                     for sh, t in zip(self.shards, terms)]
        else:
            scans = [t[5] > 0 for t in terms]
        eff = g.psum([torch.where(s, t[5], 0).sum(dim=2)
                      for s, t in zip(scans, terms)])
        return terms, scans, eff

    def _step(self, q: torch.Tensor, params: SearchParams, engine: str):
        terms, scans, eff = self._terms(q, params)
        gran = self.scan_gran()
        parts = [sh.scan(q, t, s, eff, params, engine, gran)
                 for sh, t, s in zip(self.shards, terms, scans)]
        for sh, p in zip(self.shards, parts):
            self.last_slots[sh.rank] = p[2]
        return merge_results(self.group, parts, params.k)

    def scan_inputs(self, queries, params: SearchParams, rank: int):
        """Shard ``rank``'s grouping scan kernel arguments for host queries
        [B, d] under ``params`` at the resolved slot width, as its fused
        search builds them (None when it scans nothing)."""
        q = put(np.asarray(queries, np.float32), self.group.home)
        terms, scans, eff = self._terms(q, params)
        i = self.group.ranks.index(rank)
        return self.shards[i].scan_args(q, terms[i], scans[i], eff,
                                        params.max_codes, self.scan_gran(),
                                        params.scan_budget)
