"""ADC posting-list scan, portable version (the ``engine="torch"`` path).
Counterpart of ``ivfhnsw_tpu/ops/adc.py``.

1. :func:`probe_positions` turns each query's probe set into a fixed-length
   flat gather index that reproduces the reference's ``max_codes`` budget:
   probes are consumed in ascending centroid-distance order and scanning
   stops after the list that crosses the budget (IndexIVF_HNSW.cpp:290-292);
   the fixed tail is masked.
2. :func:`adc_scan` evaluates ``d = term1 + ||y||^2 - 2<q, y_R>``
   (IndexIVF_HNSW.cpp:206-233) as a batched LUT gather + top-k.

The fused engine (``ops/cuda/adc_scan.py``) replaces step 2 with the
hand-written scan kernel; this version is the independent oracle for it.
"""

from __future__ import annotations

import torch

from ivfhnsw_tpu_torch.ops.topk import topk_smallest


def probe_positions(probes: torch.Tensor, list_offsets: torch.Tensor,
                    max_codes: int, L: int):
    """Flatten per-query probe lists into fixed-length gather indices.

    probes: [B, nprobe] centroid ids sorted by ascending query-centroid
    distance. list_offsets: [nc + 1] prefix sums of list sizes.
    max_codes: scan budget (0 = unlimited).

    Returns (pos [B, L] int64 — indices into the flat code arrays,
             seg [B, L] int64 — which probe slot each position belongs to,
             valid [B, L] bool,
             included [B, nprobe] bool — which probes made the budget)."""
    off = list_offsets.long()
    p = probes.long()
    sizes = off[p + 1] - off[p]                               # [B, P]
    cum_before = torch.cumsum(sizes, dim=1) - sizes
    included = (cum_before < max_codes) | (max_codes <= 0)
    pos, seg, valid = window_positions(p, sizes * included, off, L)
    return pos, seg, valid, included


def window_positions(lists: torch.Tensor, sizes: torch.Tensor,
                     list_offsets: torch.Tensor, L: int):
    """Fixed-length scan window over the first ``sizes[b, i]`` codes of
    list ``lists[b, i]``, lists taken in order. lists, sizes [B, n] int64;
    list_offsets [nlists + 1] int64.

    Returns (pos [B, L] int64 into the flat code arrays, 0 where invalid,
             seg [B, L] int64 — the index i each position belongs to,
             valid [B, L] bool)."""
    B, n = lists.shape
    bounds = torch.cumsum(sizes, dim=1)                       # [B, n]
    starts = bounds - sizes
    j = torch.arange(L, device=lists.device).expand(B, L).contiguous()
    seg = torch.searchsorted(bounds, j, right=True).clamp_max(n - 1)
    within = j - torch.gather(starts, 1, seg)
    pos = list_offsets[torch.gather(lists, 1, seg)] + within
    valid = j < bounds[:, -1:]
    return torch.where(valid, pos, 0), seg, valid


def adc_scan(luts: torch.Tensor, codes: torch.Tensor, bias: torch.Tensor,
             valid: torch.Tensor, k: int):
    """ADC distance evaluation + top-k over a gathered scan window.

    luts [B, M, ksub] f32 inner-product tables; codes [B, L, M] uint8;
    bias [B, L] f32 (term1 + decoded norm); valid [B, L] bool.
    Returns (dists [B, k] ascending, positions [B, k] int64 into the
    window)."""
    idx = codes.long().transpose(1, 2)                        # [B, M, L]
    t3 = torch.gather(luts, 2, idx).sum(dim=1)                # [B, L]
    dist = torch.where(valid, bias - 2.0 * t3, float("inf"))
    return topk_smallest(dist, k)
