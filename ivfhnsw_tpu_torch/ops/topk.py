"""Top-k helpers: smallest-k selection and pairwise merge.

Counterpart of ``ivfhnsw_tpu/ops/topk.py`` on ``torch.topk(largest=False)``.
Results come out sorted ascending. Between equal values ``torch.topk`` may
order indices differently from ``lax.top_k``; every top-k in both packages
carries that contract (labels may differ only between equal distances).
"""

from __future__ import annotations

import torch

from ivfhnsw_tpu_torch.utils.profiling import COUNTERS


def topk_smallest(x: torch.Tensor, k: int):
    """k smallest entries along the last axis, ascending. If k exceeds the
    axis size, the result is padded with +inf values (index n - 1).
    Returns (values, indices int64)."""
    n = x.shape[-1]
    if k > n:
        pad = torch.full(x.shape[:-1] + (k - n,), float("inf"),
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-1)
    vals, idx = torch.topk(x, k, dim=-1, largest=False, sorted=True)
    return vals, idx.clamp_max(max(n - 1, 0))


def binned_topk_smallest(x: torch.Tensor, k: int, bin_size: int = 32,
                         bmin: torch.Tensor | None = None):
    """EXACT k smallest along the last axis, in three passes: min-reduce
    bins of ``bin_size`` lanes, top-k over the bin minima, then top-k over
    the k chosen bins' lanes. A bin holding any of the true k smallest has
    bin-min <= d_k, and at most k bins can satisfy that, so the chosen bins
    cover every candidate. Falls back to :func:`topk_smallest` when
    k > n / bin_size or n % bin_size != 0.

    ``bmin``, the bin minima already computed (a scan kernel writes them
    beside its output, bins of 32 lanes), replaces the first pass; it must
    equal ``x``'s own, and ``bin_size`` must be 32. While tracing, ``COUNTERS`` counts the bins whose minima
    were given (``topk.bins_kernel``) and reduced here
    (``topk.bins_reduced``)."""
    if bmin is not None and bin_size != 32:
        raise ValueError(f"bin minima come in bins of 32 lanes, not "
                         f"{bin_size}")
    n = x.shape[-1]
    nb = n // bin_size
    if k > nb or n % bin_size:
        return topk_smallest(x, k)
    xb = x.reshape(x.shape[:-1] + (nb, bin_size))
    if bmin is None:
        bmin = xb.amin(dim=-1)
        COUNTERS.add("topk.bins_reduced", bmin.numel())
    elif bmin.shape != xb.shape[:-1]:
        raise ValueError(f"bin minima of shape {tuple(bmin.shape)}, "
                         f"expected {tuple(xb.shape[:-1])}")
    else:
        COUNTERS.add("topk.bins_kernel", bmin.numel())
    _, bsel = torch.topk(bmin, k, dim=-1, largest=False, sorted=True)
    idx = bsel.unsqueeze(-1).expand(bsel.shape + (bin_size,))
    cand = torch.gather(xb, -2, idx).reshape(x.shape[:-1] + (k * bin_size,))
    best, csel = topk_smallest(cand, k)
    sel = (torch.gather(bsel, -1, csel // bin_size) * bin_size
           + csel % bin_size)
    return best, sel


def merge_topk(d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor,
               i_b: torch.Tensor, k: int):
    """Merge two (dists, ids) top-k sets along the last axis into one."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    best_d, sel = topk_smallest(d, k)
    return best_d, torch.gather(i, -1, sel)
