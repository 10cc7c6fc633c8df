"""Lloyd's k-means on the card. Counterpart of ``ivfhnsw_tpu/ops/kmeans.py``.

- :func:`kmeans` — streaming Lloyd's for the coarse centroids; data is
  processed in blocks so nothing [n, k] materializes.
- :func:`kmeans_batched` — B independent small-k problems in one call (PQ
  subspace codebooks, B = M, and the 1-D norm quantizer, B = 1).

Random draws come from an explicit ``torch.Generator`` on the data's device
(the JAX package takes a ``jax.random`` key). The two packages draw
different numbers from the same seed, so their centroids are compared by
quantization error, not bit for bit.

Cluster sums go through :func:`ivfhnsw_tpu_torch.ops.segment.segment_sum`,
whose order of summation is fixed by the data, so one generator seed gives
the same centroids, bit for bit, on every run on the card.

Seeding is k-means++ up to 8192 centroids and :func:`hierarchical_seed`
above (coarse centroids at 2^17-2^20, where the k-step ++ loop is too
long), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.distances import assign_top1, l2sqr_pairwise
from ivfhnsw_tpu_torch.ops.segment import segment_sum

KMEANSPP_MAX_K = 8192


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kmeanspp_init(generator: torch.Generator, data: torch.Tensor,
                  k: int) -> torch.Tensor:
    """k-means++ seeding (D^2-weighted sampling) on data [n, d], or on B
    independent problems at once for data [B, n, d]. Returns [k, d] (or
    [B, k, d]) float32.

    The k-step loop stays on the device with no host sync: all uniforms are
    drawn up front, and each step samples by inverse CDF (``searchsorted``
    on the running cumulative weight), so every index stays a tensor."""
    batched = data.dim() == 3
    x = (data if batched else data[None]).float()
    B, n, d = x.shape
    dev = x.device
    rows = torch.arange(B, device=dev)
    first = torch.randint(n, (B,), generator=generator, device=dev)
    u = torch.rand((B, k), generator=generator, device=dev,
                   dtype=torch.float64)
    c = x[rows, first]                                        # [B, d]
    cents = torch.empty((B, k, d), dtype=torch.float32, device=dev)
    cents[:, 0] = c
    mind = ((x - c[:, None, :]) ** 2).sum(-1)                 # [B, n]
    for i in range(1, k):
        cum = torch.cumsum(mind + 1e-30, dim=1, dtype=torch.float64)
        target = u[:, i:i + 1] * cum[:, -1:]
        idx = torch.searchsorted(cum, target).clamp_max(n - 1)[:, 0]
        c = x[rows, idx]
        cents[:, i] = c
        mind = torch.minimum(mind, ((x - c[:, None, :]) ** 2).sum(-1))
    return cents if batched else cents[0]


def _update_with_split(sums: torch.Tensor, counts: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """Mean update over [..., k, d]; empty clusters relocate beside the
    biggest cluster's centroid with a per-cluster deterministic offset
    (split-the-biggest), as ``ivfhnsw_tpu.ops.kmeans._update_with_split``."""
    k, d = centroids.shape[-2:]
    nonempty = counts > 0
    means = sums / counts.clamp_min(1.0).unsqueeze(-1)
    big = counts.argmax(dim=-1, keepdim=True)                 # [..., 1]
    big_mean = torch.gather(
        means, -2, big.unsqueeze(-1).expand(big.shape + (d,)))  # [..., 1, d]
    offs = ((torch.arange(k, device=means.device, dtype=torch.float32) % 7.0)
            + 1.0).unsqueeze(-1) * 1e-4                       # [k, 1]
    cand = big_mean * (1.0 + offs) + offs
    return torch.where(nonempty.unsqueeze(-1), means, cand)


def _sums_and_counts(x: torch.Tensor, idx: torch.Tensor, k: int):
    """Per-cluster sums [k, d] and counts [k] of rows x [n, d] assigned to
    idx [n], in one deterministic segment sum (a ones column carries the
    counts)."""
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    acc = segment_sum(torch.cat([x, ones], dim=1), idx, k)
    return acc[:, :-1], acc[:, -1]


def _lloyd_pass(data: torch.Tensor, centroids: torch.Tensor, block_n: int,
                block_c: int = 65536):
    """One assignment pass over data [n, d] in blocks of ``block_n`` rows,
    ``block_c`` centroids per sweep step. Returns (sums [k, d], counts [k],
    sse)."""
    k, d = centroids.shape
    dev = data.device
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    csq = (centroids * centroids).sum(-1)
    for s in range(0, data.shape[0], block_n):
        blk = data[s:s + block_n]
        dist, idx = assign_top1(blk, centroids, block=block_c,
                                point_sqnorms=csq)
        blk_sums, blk_counts = _sums_and_counts(blk, idx, k)
        sums += blk_sums
        counts += blk_counts
        sse += dist.sum()
    return sums, counts, sse


def _quotas(counts: np.ndarray, k: int) -> np.ndarray:
    """Seeds per super-cluster: largest-remainder proportional quotas of k
    over the pool counts, capped by availability, any shortfall given to
    the clusters with the most headroom (the JAX package's arithmetic,
    ``ivfhnsw_tpu/ops/kmeans.py:103-122``). The quotas sum to k unless the
    pool holds fewer than k rows."""
    exact = k * counts / max(counts.sum(), 1)
    quota = np.floor(exact).astype(np.int64)
    rem = k - int(quota.sum())
    if rem > 0:
        order = np.argsort(-(exact - quota))
        quota[order[:rem]] += 1
    quota = np.minimum(quota, counts)
    short = k - int(quota.sum())
    if short > 0:
        head = counts - quota
        for s in np.argsort(-head):
            take = min(short, int(head[s]))
            quota[s] += take
            short -= take
            if short == 0:
                break
    return quota


def hierarchical_seed(generator: torch.Generator, data: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Two-level ++-style seeding for large k (the JAX package's
    ``hierarchical_seed``):

    1. k_sup = clip(k // 256, 1, 8192) super-centroids, k-means++ and 4
       Lloyd rounds on a subsample of max(32 k_sup, 16384) rows;
    2. a pool of max(8 k, that subsample) rows assigned to the supers;
    3. each super's proportional quota of seeds (:func:`_quotas`), drawn
       uniformly without replacement from its pool members; a pool smaller
       than k is topped up with random rows.

    Dense regions get many seeds, so no seed starts responsible for a huge
    slab of points. data [n, d] lives on the device that does the work;
    the permutations and draws come from ``generator``. Returns seeds
    [k, d] f32, grouped by super-cluster."""
    data = data.float()
    n, dev = data.shape[0], data.device
    k_sup = int(np.clip(k // 256, 1, 8192))
    sub_n = min(n, max(32 * k_sup, 16384))
    sub = data[torch.randperm(n, generator=generator, device=dev)[:sub_n]]
    sup = kmeanspp_init(generator, sub, k_sup)
    for _ in range(4):
        _, idx = assign_top1(sub, sup)
        sums, counts = _sums_and_counts(sub, idx, k_sup)
        sup = _update_with_split(sums, counts, sup)

    pool_n = min(n, max(8 * k, sub_n))
    pool = torch.randperm(n, generator=generator, device=dev)[:pool_n]
    step = max(1024, (1 << 28) // k_sup)     # [step, k_sup] scores <= 1 GB
    members = torch.cat([assign_top1(data[pool[o:o + step]], sup)[1]
                         for o in range(0, pool_n, step)])
    counts = torch.bincount(members, minlength=k_sup).cpu().numpy()
    quota = _quotas(counts.astype(np.int64), k)

    # Uniform draws within each super: order the pool by (super, a random
    # key) and keep the first quota[s] rows of super s.
    shuffle = torch.argsort(torch.rand(pool_n, generator=generator,
                                       device=dev))
    order = shuffle[torch.sort(members[shuffle], stable=True).indices]
    starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                          device=dev)
    sup_of = members[order]
    rank = torch.arange(pool_n, device=dev) - starts[sup_of]
    keep = rank < torch.tensor(quota, device=dev)[sup_of]
    seeds = data[pool[order[keep]]]
    short = k - seeds.shape[0]
    if short > 0:
        extra = torch.randperm(n, generator=generator, device=dev)[:short]
        seeds = torch.cat([seeds, data[extra]])
    return seeds


def lloyd_rows(k: int) -> int:
    """Data rows per assignment step of :func:`kmeans`: caps the [rows, k]
    f32 scores of one pass over the centroids at ~1 GB."""
    return min(131072, max(1024, (1 << 28) // _round_up(k, 128)))


def kmeans(generator: torch.Generator, data: torch.Tensor, k: int,
           niter: int = 25, block_c: int = 65536):
    """Streaming Lloyd's k-means on data [n, d] (a tensor on the device that
    does the work), ``block_c`` centroids per assignment sweep step.
    Returns (centroids [k, d] f32, final mean squared error)."""
    data = data.float()
    n, d = data.shape
    if n < k:
        raise ValueError(f"kmeans: n={n} < k={k}")
    block_n = lloyd_rows(k)
    if k > KMEANSPP_MAX_K:
        centroids = hierarchical_seed(generator, data, k)
    else:
        # k-means++ on a subsample of >= 32 points per cluster.
        sub_n = min(n, max(32 * k, 16384))
        perm = torch.randperm(n, generator=generator,
                              device=data.device)[:sub_n]
        centroids = kmeanspp_init(generator, data[perm], k)
    sse = torch.zeros(())
    for _ in range(niter):
        sums, counts, sse = _lloyd_pass(data, centroids, block_n, block_c)
        centroids = _update_with_split(sums, counts, centroids)
    return centroids, float(sse) / n


def kmeans_batched(generator: torch.Generator, data: torch.Tensor, k: int,
                   niter: int = 25, init: torch.Tensor | None = None):
    """Lloyd's k-means over B independent problems, data [B, n, d] ->
    centroids [B, k, d]. ``init`` [B, k, d] warm-starts it (the OPQ
    alternation retrains PQ a few iterations per rotation update) and skips
    the seeding draw."""
    data = data.float()
    B, n, d = data.shape
    if init is None:
        centroids = kmeanspp_init(generator,
                                  data[:, :min(n, max(4 * k, 4096))], k)
    else:
        centroids = init.float()
    base = (torch.arange(B, device=data.device) * k)[:, None]
    flat_x = data.reshape(B * n, d)
    for _ in range(niter):
        idx = l2sqr_pairwise(data, centroids).argmin(dim=-1)    # [B, n]
        sums, counts = _sums_and_counts(flat_x, (idx + base).reshape(-1),
                                        B * k)
        centroids = _update_with_split(sums.view(B, k, d),
                                       counts.view(B, k), centroids)
    return centroids
