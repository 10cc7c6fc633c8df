"""Batched squared-L2 distances in matmul form and the streaming exact top-k
that serves as the coarse quantizer. Counterpart of
``ivfhnsw_tpu/ops/distances.py``.

``||q - c||^2 = ||q||^2 - 2 q C^T + ||c||^2``: the inner product is one
matmul, and top-k over a large point set streams point blocks through a
running top-k merge instead of materializing [B, n] scores.

``approx=True`` stands in for the JAX package's ``jax.lax.approx_min_k``
(an XLA reduction, not a Pallas kernel, with no torch counterpart): the
bucketed partial reduction that op performs, :func:`approx_topk_smallest`.
Decided on an H100: at nc=2^17, 1024 queries, nprobe=128, the faster exact
reduce took 0.54 of the whole search, more than the third at which
"approx" would have become an alias of it (PERF.md, the approx decision).
"""

from __future__ import annotations

import math

import torch

from ivfhnsw_tpu_torch.ops.topk import (binned_topk_smallest, merge_topk,
                                        topk_smallest)

# Precision of every float32 matmul in the port. On Hopper a float32 matmul
# runs in TF32 (a 10-bit mantissa) when these flags are on; TF32 quantizes
# near-tie distances, so assignment argmins and the coarse top-k would pick
# by rounding noise (the Hopper form of the hazard documented at
# ivfhnsw_tpu/ops/distances.py:19-27). Both stay off: assignment, coarse
# selection and LUTs run in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def l2sqr_pairwise(x: torch.Tensor, y: torch.Tensor,
                   y_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances between rows of x [..., n, d] and y [..., m, d]
    -> [..., n, m] (leading dims batch, as in a vmapped call)."""
    if y_sqnorm is None:
        y_sqnorm = (y * y).sum(-1)
    x_sqnorm = (x * x).sum(-1)
    # in place, bit for bit x_sqnorm - 2 * ip + y_sqnorm (-2 * ip + a is
    # a - 2 * ip exactly): no [..., n, m] temporaries
    ip = torch.matmul(x, y.transpose(-1, -2)).mul_(-2.0)
    return ip.add_(x_sqnorm.unsqueeze(-1)).add_(y_sqnorm.unsqueeze(-2))


def inner_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [n, d] @ y [m, d]^T -> [n, m], in full float32 (TF32 is off)."""
    return x @ y.transpose(-1, -2)


def approx_topk_smallest(x: torch.Tensor, k: int,
                         recall_target: float = 0.95):
    """Approximate k smallest along the last axis, ascending: the bucketed
    partial reduction of ``jax.lax.approx_min_k``. Lane i falls in bucket
    i mod L (strided, so neighbours with nearby ids, such as centroids
    seeded super by super, spread over buckets), each bucket keeps its
    minimum, and an exact top-k runs over the L minima. Two of the true k smallest in one bucket lose one
    of them; with L >= (k - 1) / (2 (1 - recall_target)) buckets the
    expected share kept is at least ``recall_target`` (the TPU-KNN bound
    that approx_min_k sizes its buckets by). Falls back to the exact
    :func:`topk_smallest` when that leaves fewer than 2 lanes per bucket.
    Returns (values, indices int64)."""
    n = x.shape[-1]
    nbuck = max(k, math.ceil((k - 1) / max(2.0 * (1.0 - recall_target),
                                           1e-9)))
    width = -(-n // nbuck)
    if width < 2:
        return topk_smallest(x, k)
    nbuck = -(-n // width)
    if nbuck * width != n:
        pad = torch.full(x.shape[:-1] + (nbuck * width - n,), float("inf"),
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-1)
    bmin, barg = x.reshape(x.shape[:-1] + (width, nbuck)).min(dim=-2)
    best, bsel = topk_smallest(bmin, k)
    sel = torch.gather(barg, -1, bsel) * nbuck + bsel
    return best, sel.clamp_max(n - 1)


def streaming_topk_l2(queries: torch.Tensor, points: torch.Tensor, k: int,
                      block: int = 65536,
                      point_sqnorms: torch.Tensor | None = None,
                      exact_reduce: str = "topk", approx: bool = False,
                      recall_target: float = 0.95):
    """k nearest points (squared L2) for each query, streaming ``points`` in
    blocks of ``block`` rows with a running top-k merge. Returns
    (dists [B, k] f32, idxs [B, k] int64) sorted ascending.

    exact_reduce="binned" selects within each block by the 3-pass bin-min
    reduction (:func:`binned_topk_smallest`): the same result up to the
    order of equal distances. approx=True selects within each block by
    :func:`approx_topk_smallest` at ``recall_target`` (the JAX package's
    approx_min_k); the merge across blocks stays exact.

    The [B, block] score block is formed in place, in the order
    (||q||^2 - 2 q.p) + ||p||^2, so a step holds one such block. At k=1
    (assignment, the in-stream ground truth) a block is reduced by a
    minimum, the first index among equal distances: one read of the block
    where ``torch.topk`` cost half the exact assignment's time at nc=2^20
    (``tools/assign_probe.py``)."""
    if exact_reduce not in ("topk", "binned"):
        raise ValueError(f"exact_reduce must be 'topk' or 'binned', "
                         f"got {exact_reduce!r}")
    B = queries.shape[0]
    n = points.shape[0]
    block = max(128, min(block, _round_up(n, 128)))
    if point_sqnorms is None:
        point_sqnorms = (points * points).sum(-1)
    q_sqnorm = (queries * queries).sum(-1)
    kk = min(k, block)
    best_d = torch.full((B, k), float("inf"), dtype=torch.float32,
                        device=queries.device)
    best_i = torch.zeros((B, k), dtype=torch.int64, device=queries.device)
    for s in range(0, n, block):
        # -2 * ip + ||q||^2 is ||q||^2 - 2 * ip bit for bit
        dists = (queries @ points[s:s + block].T).mul_(-2.0)
        dists.add_(q_sqnorm[:, None]).add_(point_sqnorms[None, s:s + block])
        if approx and kk < dists.shape[1]:
            blk_d, blk_j = approx_topk_smallest(dists, kk, recall_target)
        elif exact_reduce == "binned":
            blk_d, blk_j = binned_topk_smallest(dists, kk, bin_size=32)
        elif kk == 1:
            blk_d, blk_j = dists.min(dim=1, keepdim=True)
        else:
            blk_d, blk_j = topk_smallest(dists, kk)
        best_d, best_i = merge_topk(best_d, best_i, blk_d, blk_j + s, k)
    return best_d, best_i


def assign_top1(queries: torch.Tensor, points: torch.Tensor,
                block: int = 65536,
                point_sqnorms: torch.Tensor | None = None):
    """Nearest-point id for each query (the reference's ``assign``,
    IndexIVF_HNSW.cpp:68-72). Returns (dist [B], idx [B] int64)."""
    d, i = streaming_topk_l2(queries, points, 1, block=block,
                             point_sqnorms=point_sqnorms)
    return d[:, 0], i[:, 0]
