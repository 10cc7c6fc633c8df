"""The least time an H100 could take for a scan: the larger of its bytes
(each input read once, each output written once) over the memory rate and
its f32 operations over the f32 peak, the H100 SXM data-sheet figures at
700 W."""

from __future__ import annotations

import torch

HBM_BYTES_PER_MS = 3.35e9   # H100 SXM HBM3, 3.35 TB/s
F32_OPS_PER_MS = 67e9       # H100 SXM f32 outside the tensor cores


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms / bound_by of a kernel record: the larger of bytes over the
    HBM rate and f32 operations over the f32 peak."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return ({"bound_ms": by_bytes, "bound_by": "bytes"} if by_bytes >= by_ops
            else {"bound_ms": by_ops, "bound_by": "operations"})


def rows_touched(start: torch.Tensor, length: torch.Tensor, n: int) -> int:
    """Distinct store rows in the union of the slots [start, start + len)."""
    m = length > 0
    one = torch.ones(int(m.sum()), dtype=torch.int32, device=start.device)
    delta = torch.zeros(n + 1, dtype=torch.int32, device=start.device)
    delta.index_add_(0, start[m], one)
    delta.index_add_(0, start[m] + length[m].long(), -one)
    return int((delta.cumsum(0)[:n] > 0).sum())


def scan_bound(args, out_numel: int, row_bytes: int, ops_per_lane: int,
               extra_bytes: int = 0) -> dict:
    """bound() of an ADC scan over ``args`` (lut, norm_tab, codes,
    norm_codes, start, length, bias, ...): LUTs, norm table and schedule
    read once, ``row_bytes`` per touched store row, the f32 output written
    once; ``ops_per_lane`` f32 operations per valid lane."""
    lut, ntab, codes, _, start, length = args[:6]
    nbytes = (lut.numel() * 4 + ntab.numel() * 4 + start.numel() * 16
              + rows_touched(start, length, codes.shape[0]) * row_bytes
              + out_numel * 4 + extra_bytes)
    return bound(nbytes, int(length.sum()) * ops_per_lane)
