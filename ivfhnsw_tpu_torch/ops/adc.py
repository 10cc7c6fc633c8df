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


def window_scan(luts: torch.Tensor, term1: torch.Tensor, window: tuple,
                store, norm_tab: torch.Tensor, k: int):
    """The portable scan over a window (pos, seg, valid) of
    :func:`window_positions` into ``store`` (a
    ``models.storage.PostingListStore``): distance term1[b, seg] +
    norm_tab[norm code] - 2 * sum_m luts[b, m, code_m], then the top-k.
    luts [B, M, ksub]; term1 [B, n] f32.

    Returns (dists [B, k] ascending, labels [B, k] int64, -1 where the
    distance is +inf)."""
    pos, seg, valid = window
    bias = (torch.gather(term1, 1, seg)
            + norm_tab[store.norm_codes_t[pos].long()])
    dists, sel = adc_scan(luts, store.codes_t[pos], bias, valid, k)
    labels = torch.gather(store.ids_t[pos], 1, sel).long()
    return dists, torch.where(torch.isfinite(dists), labels, -1)


def adc_distances(luts: torch.Tensor, codes: torch.Tensor,
                  bias: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ADC distances ``bias - 2 * sum_m luts[b, m, codes[b, l, m]]`` over a
    gathered scan window, +inf where not ``valid``.

    luts [B, M, ksub] f32 inner-product tables; codes [B, L, M] uint8;
    bias [B, L] f32 (term1 + decoded norm); valid [B, L] bool. Returns
    [B, L] f32."""
    idx = codes.long().transpose(1, 2)                        # [B, M, L]
    t3 = torch.gather(luts, 2, idx).sum(dim=1)                # [B, L]
    return torch.where(valid, bias - 2.0 * t3, float("inf"))


def adc_scan(luts: torch.Tensor, codes: torch.Tensor, bias: torch.Tensor,
             valid: torch.Tensor, k: int):
    """:func:`adc_distances` + top-k. Returns (dists [B, k] ascending,
    positions [B, k] int64 into the window)."""
    return topk_smallest(adc_distances(luts, codes, bias, valid), k)
