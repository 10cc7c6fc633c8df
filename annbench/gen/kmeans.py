"""The benchmark's own plain k-means for its PQ and norm-PQ codebooks (the
upstream trains them on ``nsubt`` sampled rows; the benchmark makes them so
that both sides get the same ones)."""

from __future__ import annotations

import torch


def _lloyd(x: torch.Tensor, cents: torch.Tensor, niter: int) -> torch.Tensor:
    """Batched Lloyd iterations: x [B, n, s], cents [B, k, s]; an empty
    cluster keeps its centroid."""
    B, n, _ = x.shape
    k = cents.shape[1]
    for _ in range(niter):
        d = (cents * cents).sum(-1)[:, None, :] - 2.0 * torch.bmm(
            x, cents.transpose(1, 2))
        a = d.argmin(dim=-1)                                   # [B, n]
        sums = torch.zeros_like(cents).scatter_add_(
            1, a[:, :, None].expand(-1, -1, x.shape[2]), x)
        cnt = torch.zeros((B, k), device=x.device, dtype=x.dtype
                          ).scatter_add_(1, a, torch.ones_like(a, dtype=x.dtype))
        cents = torch.where(cnt[:, :, None] > 0,
                            sums / cnt.clamp_min(1)[:, :, None], cents)
    return cents


def pq_train(r: torch.Tensor, M: int, g: torch.Generator,
             niter: int = 25, ksub: int = 256) -> torch.Tensor:
    """Codebooks [M, ksub, dsub] of residuals r [n, M*dsub]: ksub distinct
    rows as the start, then ``niter`` Lloyd iterations per subspace."""
    n, d = r.shape
    x = r.reshape(n, M, d // M).transpose(0, 1).contiguous()
    pick = torch.randperm(n, generator=g, device=r.device)[:ksub]
    return _lloyd(x, x[:, pick].clone(), niter)


def kmeans_1d(v: torch.Tensor, k: int, g: torch.Generator,
              niter: int = 25) -> torch.Tensor:
    """k centroids of the scalars v [n], started at k distinct samples."""
    pick = torch.randperm(v.shape[0], generator=g, device=v.device)[:k]
    x = v.reshape(1, -1, 1).float()
    return _lloyd(x, x[:, pick].clone(), niter).reshape(k)
