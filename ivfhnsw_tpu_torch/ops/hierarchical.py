"""Two-level coarse assigner for large centroid sets. Counterpart of
``ivfhnsw_tpu/ops/hierarchical.py``.

Exact assignment costs n * nc * d multiply-adds: at 134M points and
nc=2^17 that is 4.5e15 FLOP. The two-level assigner clusters the nc
centroids into super-clusters, routes each point to its ``w`` nearest
supers and takes the exact argmin of ||c||^2 - 2 x.c over those supers'
members only.

Membership is capacity-bounded (cap = 4x the average, nearest-first greedy
spill to the next-nearest super with room: :func:`ops.routed_coarse.
greedy_partition`), so one collapsed super cannot inflate every member
matmul. Accuracy presumes clusters of centroids; :meth:`TwoLevelAssigner.
exact_match_rate` measures it before a build adopts the assigner.

GPU shape: pass j of the ``w`` passes sorts the points by their j-th
nearest super on the device (a stable sort) and scores each super's bucket
against that super's members with one batched matmul over a chunk of
supers (``torch.bmm`` of [s, Bp, d] by [s, d, cap]), the chunk's supers
being those of similar bucket sizes so the padding stays small. Buckets
are as large as the points routed to them: no bucket overflows, so a
point's result does not depend on the batch it came in. A point whose
every super has no members falls back to the exact sweep. (The JAX
package's ``lax.scan`` over supers, host bucketing and overflow retry are
TPU shapes, not ported.)
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.distances import assign_top1, streaming_topk_l2
from ivfhnsw_tpu_torch.ops.routed_coarse import greedy_partition

# Elements of a [s, Bp, max(cap, d)] score or point block per member step.
MEMBER_ELEMS = 1 << 25
# Points per routing step: caps the [rows, S] super scores at ~1 GB.
ROUTE_ELEMS = 1 << 28


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TwoLevelAssigner:
    """Approximate nearest-centroid assigner: k-means over the centroid set
    and per-point top-``w`` super probes, each pass a set of batched member
    matmuls. ``centroids`` [nc, d] sets the device."""

    def __init__(self, centroids: torch.Tensor, n_super: int | None = None,
                 w: int = 8, generator: torch.Generator | None = None,
                 niter: int = 15):
        from ivfhnsw_tpu_torch.ops.kmeans import kmeans
        centroids = centroids.float().contiguous()
        nc = centroids.shape[0]
        n_super = n_super or max(16, min(nc // 2, nc // 64 or 16))
        if generator is None:
            generator = torch.Generator(
                device=centroids.device).manual_seed(0)
        sup, _ = kmeans(generator, centroids, n_super, niter=niter)
        self._init_from(centroids, sup, None, None, w)

    def _init_from(self, centroids, sup, members, valid, w):
        self.w = w
        self.centroids = centroids
        self.centroid_norms = (centroids * centroids).sum(1)
        self.supers = sup
        self.super_sqn = (sup * sup).sum(1)
        self.n_super = int(sup.shape[0])
        nc = centroids.shape[0]
        if members is None:
            cap = max(8, -(-4 * nc // self.n_super))
            members, valid = greedy_partition(centroids, sup, cap,
                                              min(8, self.n_super))
        dev = centroids.device
        self.members = torch.as_tensor(np.array(members), device=dev).long()
        self.member_valid = torch.as_tensor(np.array(valid), device=dev)
        self.cap = int(self.members.shape[1])
        # -2 folded into the member block (exact: a power of two), so a
        # bucket's scores are ||c||^2 - 2 x.c after one add; +inf norms on
        # padding keep it out of every argmin.
        self._neg2_block = centroids[self.members] * -2.0
        self._norms = torch.where(self.member_valid,
                                  self.centroid_norms[self.members],
                                  float("inf"))

    @classmethod
    def from_state(cls, centroids: torch.Tensor, supers, members,
                   member_valid, w: int = 8) -> "TwoLevelAssigner":
        """An assigner from given supers [S, d] and membership [S, cap]
        (e.g. the JAX assigner's arrays), without k-means or partition."""
        self = cls.__new__(cls)
        centroids = centroids.float().contiguous()
        self._init_from(centroids,
                        torch.as_tensor(np.array(supers, np.float32),
                                        device=centroids.device),
                        members, member_valid, w)
        return self

    def _route(self, x: torch.Tensor) -> torch.Tensor:
        """Top-w supers per point [n, w] int64."""
        w = min(self.w, self.n_super)
        rows = max(1024, ROUTE_ELEMS // max(self.n_super, 1))
        return torch.cat([
            streaming_topk_l2(x[o:o + rows], self.supers, w,
                              block=self.n_super,
                              point_sqnorms=self.super_sqn)[1]
            for o in range(0, x.shape[0], rows)])

    def _exact(self, x: torch.Tensor) -> torch.Tensor:
        """Exact nearest centroid [n] int64, row-batched so a step's
        [rows, block] scores stay ~1 GB."""
        block = min(65536, int(self.centroids.shape[0]))
        rows = max(1024, ROUTE_ELEMS // block)
        return torch.cat([
            assign_top1(x[o:o + rows], self.centroids, block=block,
                        point_sqnorms=self.centroid_norms)[1]
            for o in range(0, x.shape[0], rows)])

    def _one_pass(self, x: torch.Tensor, sid: torch.Tensor,
                  best_d: torch.Tensor, best_i: torch.Tensor) -> None:
        """The pass over probe rank sid [n]: each point scored against the
        members of super sid[point]; folds a strictly smaller distance into
        (best_d, best_i) in place (so an earlier pass wins a tie)."""
        dev = x.device
        order = torch.sort(sid, stable=True).indices
        counts = torch.bincount(sid, minlength=self.n_super).cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        by_size = np.argsort(-counts, kind="stable")
        width = max(self.cap, x.shape[1])
        i = 0
        while i < self.n_super and counts[by_size[i]] > 0:
            Bp = _round_up(int(counts[by_size[i]]), 8)
            s = max(1, min(self.n_super - i, MEMBER_ELEMS // (Bp * width)))
            chunk = by_size[i:i + s]
            i += s
            ch = torch.as_tensor(chunk, device=dev)
            lane = torch.arange(Bp, device=dev)
            ok = lane < torch.as_tensor(counts[chunk], device=dev)[:, None]
            pos = torch.as_tensor(starts[chunk], device=dev)[:, None] + lane
            pts = order[torch.where(ok, pos, 0)]                 # [s, Bp]
            scores = torch.bmm(x[pts], self._neg2_block[ch].transpose(1, 2))
            dmin, j = scores.add_(self._norms[ch][:, None, :]).min(dim=-1)
            ids = torch.gather(self.members[ch], 1, j)
            pts, dmin, ids = pts[ok], dmin[ok], ids[ok]
            upd = dmin < best_d[pts]
            best_d[pts[upd]] = dmin[upd]
            best_i[pts[upd]] = ids[upd]

    def assign_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """Routed nearest-centroid ids [n] int64 of rows x [n, d] on the
        assigner's device, each the exact argmin over the members of its
        top-w supers; a point no pass resolved takes the exact sweep."""
        x = x.float()
        n = x.shape[0]
        if n == 0:
            return torch.zeros(0, dtype=torch.int64, device=x.device)
        sids = self._route(x)
        best_d = torch.full((n,), float("inf"), device=x.device)
        best_i = torch.zeros(n, dtype=torch.int64, device=x.device)
        for j in range(sids.shape[1]):
            self._one_pass(x, sids[:, j].contiguous(), best_d, best_i)
        bad = torch.isinf(best_d)
        if bool(bad.any()):
            best_i[bad] = self._exact(x[bad])
        return best_i

    def assign(self, x, batch: int = 1 << 20) -> np.ndarray:
        """Routed ids [n] int32 (host) of host rows x [n, d], uploaded
        ``batch`` rows at a time."""
        x = np.asarray(x, np.float32)
        dev = self.centroids.device
        return np.concatenate([
            self.assign_tensor(torch.as_tensor(x[o:o + batch], device=dev))
            .cpu().numpy().astype(np.int32)
            for o in range(0, x.shape[0], batch)] or
            [np.zeros(0, np.int32)])

    def assign_device(self, x_dev: torch.Tensor) -> np.ndarray:
        """Routed ids [n] int32 (host) of rows already on the assigner's
        device: the rows never cross to the host, only the keys do."""
        return self.assign_tensor(x_dev).cpu().numpy().astype(np.int32)

    def exact_match_rate(self, x_sample, exact_assign_fn) -> float:
        """Share of sample points routed to their exact nearest centroid;
        ``exact_assign_fn`` maps the sample to the exact ids."""
        approx = self.assign(x_sample)
        exact = np.asarray(exact_assign_fn(x_sample))
        return float((approx == exact).mean())
