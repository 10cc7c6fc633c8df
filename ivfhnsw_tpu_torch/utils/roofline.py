"""The least time an H100 could take for a scan: the larger of its bytes
(each input read once, each output written once) over the memory rate and
its f32 operations over the f32 peak, the H100 SXM data-sheet figures at
700 W.

Beside the bound, a scan record carries ``lookup_ms``: the least time the
card's shared memory could take for the scan's LUT lookups if no two lanes
of a warp ever met in a bank (each SM serves 32 four-byte words per clock).
It is not part of ``bound_ms``; it says how far a lookup-bound kernel is
from the rate of its own mechanism. :func:`lookup_wavefronts` counts what
the lookups of a schedule cost when lanes do meet in a bank."""

from __future__ import annotations

import functools
import subprocess

import torch

HBM_BYTES_PER_MS = 3.35e9   # H100 SXM HBM3, 3.35 TB/s
F32_OPS_PER_MS = 67e9       # H100 SXM f32 outside the tensor cores


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms / bound_by of a kernel record: the larger of bytes over the
    HBM rate and f32 operations over the f32 peak."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return ({"bound_ms": by_bytes, "bound_by": "bytes"} if by_bytes >= by_ops
            else {"bound_ms": by_ops, "bound_by": "operations"})


@functools.lru_cache(maxsize=None)
def max_sm_clock_mhz(index: int = 0) -> float:
    """The card's maximum SM clock in MHz, as ``nvidia-smi
    --query-gpu=clocks.max.sm`` gives it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", str(index)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0])


def lookup_ms(lookups: float, device: torch.device) -> float | None:
    """Milliseconds that ``lookups`` 4-byte shared-memory reads take at one
    word per bank per clock on every SM of CUDA device ``device`` (SM count
    x 32 x the maximum SM clock); None for a device that is not a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return lookups / (sms * 32 * max_sm_clock_mhz(index) * 1e3)


def rows_touched(start: torch.Tensor, length: torch.Tensor, n: int) -> int:
    """Distinct store rows in the union of the slots [start, start + len)."""
    m = length > 0
    one = torch.ones(int(m.sum()), dtype=torch.int32, device=start.device)
    delta = torch.zeros(n + 1, dtype=torch.int32, device=start.device)
    delta.index_add_(0, start[m], one)
    delta.index_add_(0, start[m] + length[m].long(), -one)
    return int((delta.cumsum(0)[:n] > 0).sum())


def scan_bound(args, out_numel: int, row_bytes: int, ops_per_lane: int,
               extra_bytes: int = 0, lookups_per_lane: int | None = None
               ) -> dict:
    """bound() of an ADC scan over ``args`` (lut, norm_tab, codes,
    norm_codes, start, length, bias, ...): LUTs, norm table and schedule
    read once, ``row_bytes`` per touched store row, the f32 output written
    once; ``ops_per_lane`` f32 operations per valid lane. Also
    ``lookup_ms`` (:func:`lookup_ms`) of ``lookups_per_lane`` table lookups
    per valid lane (default M + 1: the LUT rows and the norm table)."""
    lut, ntab, codes, _, start, length = args[:6]
    nbytes = (lut.numel() * 4 + ntab.numel() * 4 + start.numel() * 16
              + rows_touched(start, length, codes.shape[0]) * row_bytes
              + out_numel * 4 + extra_bytes)
    valid = int(length.sum())
    if lookups_per_lane is None:
        lookups_per_lane = codes.shape[1] + 1
    return {**bound(nbytes, valid * ops_per_lane),
            "lookup_ms": lookup_ms(valid * lookups_per_lane, lut.device)}


def grouping_scan_bound(args, out: torch.Tensor, gran: int) -> dict:
    """bound() of a grouping scan over ``args`` (lut, norm_tab, t2, codes,
    norm_codes, subc, start, length, bias, seg) whose output is ``out``
    [B, S*gran], counting what any implementation of the function must
    move and do: the LUTs, norm table, term2 tables and schedule (20 B a
    slot) read once; of the store, one ``subc`` byte per touched row, and
    the M + 1 code and norm bytes only of rows that are kept (finite in
    ``out``) for at least one query; the f32 output written once; M + 2
    f32 additions per kept lane. ``lookup_ms`` (:func:`lookup_ms`) counts
    M + 2 table lookups per kept lane and the one term2 lookup of a pruned
    lane. Also "kept_lanes" and "filled_lanes"."""
    lut, ntab, t2, codes, _, _, start, length = args[:8]
    N, M = codes.shape
    kept = torch.isfinite(out).nonzero()                     # [K, 2]
    rows = start[kept[:, 0], kept[:, 1] // gran] + kept[:, 1] % gran
    kept_rows = torch.zeros(N, dtype=torch.bool, device=codes.device)
    kept_rows[rows] = True
    n_kept, filled = int(kept.shape[0]), int(length.sum())
    nbytes = (lut.numel() * 4 + ntab.numel() * 4 + t2.numel() * 4
              + start.numel() * 20 + rows_touched(start, length, N)
              + int(kept_rows.sum()) * (M + 1) + out.numel() * 4)
    return {**bound(nbytes, n_kept * (M + 2)),
            "lookup_ms": lookup_ms(n_kept * (M + 2) + (filled - n_kept),
                                   lut.device),
            "kept_lanes": n_kept, "filled_lanes": filled}


def lookup_wavefronts(codes: torch.Tensor, norm_codes: torch.Tensor,
                      start: torch.Tensor, length: torch.Tensor, gran: int,
                      lanes: int = 32, chunk: int = 1 << 17) -> tuple:
    """(lookups, wavefronts) of a scan's table lookups on a schedule, as
    the scan kernels issue them: each warp instruction looks up one LUT row
    (or the norm table) at the code bytes of ``lanes`` consecutive rows of a
    slot (rows 32j .. 32j + 31 of its first min(len, gran), the last group
    clipped), and word k of a row sits in bank k mod 32 (rows start on a
    bank-0 boundary), so the instruction takes as many shared-memory
    wavefronts as the most distinct words it asks of one bank. Lanes past
    a slot's end ask for nothing (the min kernel's duplicates of the last
    row ask for words already asked). ``chunk`` groups are counted at a
    time."""
    M = codes.shape[1]
    ln = length.clamp(max=gran).long()
    ng = (ln + lanes - 1) // lanes
    m = ng > 0
    st, L, G = start[m], ln[m], ng[m]
    slot = torch.repeat_interleave(torch.arange(G.numel(),
                                                device=start.device), G)
    j = torch.arange(slot.numel(), device=start.device) - (
        torch.cumsum(G, 0) - G)[slot]
    g0 = st[slot] + j * lanes                     # each group's first row
    gl = torch.clamp(L[slot] - j * lanes, max=lanes)
    lane = torch.arange(lanes, device=start.device)
    waves = 0
    for a in range(0, g0.numel(), chunk):
        b0, bl = g0[a:a + chunk], gl[a:a + chunk]
        rows = b0[:, None] + torch.minimum(lane, bl[:, None] - 1)
        tab = torch.cat([codes[rows], norm_codes[rows][..., None]], 2)
        present = torch.zeros((rows.shape[0], M + 1, 256), dtype=torch.bool,
                              device=start.device)
        present.scatter_(2, tab.transpose(1, 2).long(), True)
        waves += int(present.view(-1, M + 1, 8, 32).sum(2).amax(-1).sum())
    return int(gl.sum()) * (M + 1), waves
