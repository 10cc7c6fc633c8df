"""Two-level routed coarse probe selection for large centroid sets.
Counterpart of ``ivfhnsw_tpu/ops/routed_coarse.py``.

The nc centroids are partitioned over S super-clusters (k-means over the
centroid set, a capacity-bounded partition that places every centroid in
exactly one super). A query scores the S supers, takes its top-``w``, and
scores the members of those supers exactly: its ``nprobe`` probes are the
nearest of those ``w * cap`` candidates, with exact distances. Only the
candidate cut is approximate, as the reference's HNSW descent
(hnswalg.cpp:48-109) is, ``w`` playing its efSearch; the routing presumes
clusters of centroids (measure the probe overlap against the exact sweep
before adopting it).

The JAX package packs list size, tile offset and centroid id into float32
channels of the centroid block and refuses values of 2^24 or more. Here the
per-member metadata is an int64 side table [S, cap, 3] of (list size, first
row of the list in the flat store, centroid id), gathered with the same
super indices as the centroid block [S, cap, d], so list offsets of a store
of any size stay exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.topk import topk_smallest

# Elements of a gathered [queries, w * cap, d] candidate block per step.
GATHER_ELEMS = 1 << 26


def greedy_partition(centroids: torch.Tensor, supers: torch.Tensor, cap: int,
                     n_choice: int = 8):
    """Capacity-bounded partition of centroids [nc, d] over supers [S, d]:
    centroids in ascending distance to their nearest super take, each in
    turn, the nearest of their ``n_choice`` nearest supers that has room,
    else the emptiest super. Every centroid is placed exactly once.
    Returns (members [S, cap] int32, valid [S, cap] bool) as numpy, the
    JAX package's ``greedy_partition`` for the same supers."""
    nc, S = centroids.shape[0], supers.shape[0]
    if S * cap < nc:
        raise ValueError(f"total capacity {S}x{cap} < nc={nc}")
    n_choice = min(n_choice, S)
    super_sqn = (supers * supers).sum(1)
    rows = max(1024, min(nc, (1 << 28) // max(S, 1)))
    cd, cids = [], []
    for off in range(0, nc, rows):
        d_blk, i_blk = streaming_topk_l2(centroids[off:off + rows], supers,
                                         n_choice, point_sqnorms=super_sqn)
        cd.append(d_blk[:, 0].cpu())
        cids.append(i_blk.cpu())
    order = np.argsort(torch.cat(cd).numpy(), kind="stable")
    choices = torch.cat(cids).tolist()
    fill = [0] * S
    lists: list[list[int]] = [[] for _ in range(S)]
    for c in order.tolist():
        for s in choices[c]:
            if fill[s] < cap:
                break
        else:   # every choice is full: the emptiest super (first of ties)
            s = min(range(S), key=fill.__getitem__)
        lists[s].append(c)
        fill[s] += 1
    members = np.zeros((S, cap), np.int32)
    valid = np.zeros((S, cap), bool)
    for s, mem in enumerate(lists):
        members[s, :len(mem)] = mem
        valid[s, :len(mem)] = True
    return members, valid


class RoutedTable(NamedTuple):
    """One store's routing table: block [S, cap, d] f32 member centroids;
    sqn [S, cap] f32 their squared norms, +inf on padding (so a padded
    candidate sorts last); meta [S, cap, 3] int64 (list size, first row of
    the list, centroid id), zero on padding."""

    block: torch.Tensor
    sqn: torch.Tensor
    meta: torch.Tensor


class RoutedCoarse:
    """Search-time routing structure over a centroid set: super centroids
    from k-means over the centroids and the partition of
    :func:`greedy_partition` (derived data, saved by :meth:`save`, reloaded
    by :meth:`from_state`). :meth:`build_table` folds in one store's list
    sizes and offsets."""

    def __init__(self, centroids: torch.Tensor, n_super: int | None = None,
                 cap_factor: float = 1.5,
                 generator: torch.Generator | None = None, niter: int = 15,
                 n_choice: int = 8):
        from ivfhnsw_tpu_torch.ops.kmeans import kmeans
        centroids = centroids.float()
        nc = centroids.shape[0]
        n_super = n_super or max(16, min(nc // 2, nc // 64 or 16))
        if generator is None:
            generator = torch.Generator(
                device=centroids.device).manual_seed(0)
        sup, _ = kmeans(generator, centroids, n_super, niter=niter)
        self._init_from(centroids, sup, None, None, cap_factor, n_choice)

    def _init_from(self, centroids, sup, members, valid, cap_factor=1.5,
                   n_choice=8):
        self.centroids = centroids
        self.nc, self.d = centroids.shape
        self.supers = sup
        self.super_sqn = (sup * sup).sum(1)
        self.n_super = int(sup.shape[0])
        if members is None:
            self.cap = max(8, (int(-(-cap_factor * self.nc // self.n_super))
                               + 7) & ~7)
            members, valid = greedy_partition(centroids, sup, self.cap,
                                              n_choice)
        else:
            self.cap = int(members.shape[1])
        self.members = np.asarray(members, np.int32)
        self.valid = np.asarray(valid, bool)

    @classmethod
    def from_state(cls, centroids: torch.Tensor, supers, members,
                   valid) -> "RoutedCoarse":
        """Rebuild from :meth:`save`d arrays (numpy or tensors) without the
        k-means or the partition; ``centroids`` [nc, d] come from the index
        and set the device."""
        self = cls.__new__(cls)
        centroids = centroids.float()
        self._init_from(centroids,
                        torch.as_tensor(np.array(supers, np.float32),
                                        device=centroids.device),
                        np.asarray(members), np.asarray(valid))
        return self

    def save(self, path: str) -> None:
        """``np.savez`` of supers, members and valid: the JAX package's
        keys and dtypes, so either package reads the other's file."""
        np.savez(path, supers=self.supers.cpu().numpy().astype(np.float32),
                 members=self.members, valid=self.valid)

    def build_table(self, centroid_norms: torch.Tensor,
                    list_offsets: torch.Tensor) -> RoutedTable:
        """The :class:`RoutedTable` of a store with list offsets
        ``list_offsets`` [nc+1] (any integer dtype)."""
        dev = self.centroids.device
        m = torch.as_tensor(self.members, device=dev).long()
        ok = torch.as_tensor(self.valid, device=dev)
        off = list_offsets.to(device=dev, dtype=torch.int64)
        meta = torch.stack([off[m + 1] - off[m], off[m], m], dim=-1)
        return RoutedTable(
            block=self.centroids[m].contiguous(),
            sqn=torch.where(ok, centroid_norms.float()[m], float("inf")),
            meta=torch.where(ok[..., None], meta, 0))


def routed_select_ext(queries: torch.Tensor, supers: torch.Tensor,
                      super_sqn: torch.Tensor, table: RoutedTable, *,
                      nprobe: int, w: int):
    """Routed probe selection with the schedule's per-probe fields.

    queries [B, d]; supers [S, d]; super_sqn [S]; table from
    :meth:`RoutedCoarse.build_table`. Each query's top-``w`` supers (by
    ||s||^2 - 2 q.s), then the exact (||q||^2 - 2 q.c) + ||c||^2 of their
    w * cap members and the ``nprobe`` nearest. Requires w * cap >= nprobe
    (``w`` is clamped to S first). The members are gathered for a few
    queries at a time (GATHER_ELEMS), never for the whole batch.

    Returns (qc_dists f32, probes int64, term1 f32 = qc_dist - ||c||^2,
    sizes int64, lo int64 = first row of the probe's list), all [B, nprobe]
    and ascending by qc_dist."""
    B, d = queries.shape
    S, cap = table.sqn.shape
    w = min(w, S)
    if w * cap < nprobe:
        raise ValueError(f"w*cap = {w}*{cap} < nprobe={nprobe}")
    qsq = (queries * queries).sum(1)
    s_d = (queries @ supers.T).mul_(-2.0).add_(super_sqn[None, :])
    _, sup = topk_smallest(s_d, w)                             # [B, w]
    outs = []
    step = max(1, GATHER_ELEMS // (w * cap * d))
    for o in range(0, B, step):
        q, sp = queries[o:o + step], sup[o:o + step]
        b = q.shape[0]
        ip = torch.bmm(table.block[sp].view(b, w * cap, d),
                       q[:, :, None])[..., 0]                  # [b, w*cap]
        term1 = qsq[o:o + step, None] - 2.0 * ip
        dist = term1 + table.sqn[sp].view(b, w * cap)
        d2, sel = topk_smallest(dist, nprobe)
        meta = torch.gather(table.meta[sp].view(b, w * cap, 3), 1,
                            sel[:, :, None].expand(b, nprobe, 3))
        outs.append((d2, meta[..., 2], torch.gather(term1, 1, sel),
                     meta[..., 0], meta[..., 1]))
    return tuple(torch.cat(parts) for parts in zip(*outs))
