"""The scan lab: timing variants of the ADC scan (``csrc/scan_lab.cu``), the
Hopper counterparts of the TPU lab rigs L1-L4 of ``tools/kernel_lab.py``.

Six wrappers, each with its plain PyTorch version; :data:`LAUNCHES` counts
the launches of each variant:

- :func:`scan_direct` (K1-K4, ``ivfhnsw_tpu/ops/pallas/adc_scan.py:216``,
  ``:368``, ``:545``, ``:685``): the production kernels as first ported
  (row-major LUT, direct code loads, every lane of a warp in the same row,
  plain stores), kept so that every run times the first design beside the
  current one on one card;
- :func:`scan_skew` (the same four kernels): a bank-skewed LUT, in which
  the 32 lanes of a warp read 32 different banks at every lookup whatever
  the codes (:func:`skew_word`, :func:`lane_row`). It removes the bank
  conflicts of the random lookups and pays for it in operations and
  registers; it is kept in the lab because it measured slower than the
  production kernels (``PERF.md``);
- :func:`scan_runs` (L1, ``kernel_lab.py:87 _adc_kernel_v2``, one DMA per
  4-tile run): one TMA bulk copy per 1024-code slot into an mbarrier ring;
- :func:`scan_pipelined` (L2 ``:525 _adc_kernel_quad`` / ``:449
  _adc_kernel_quad_nb``, L3 ``:285 _adc_kernel_v1b``, L4 ``:694
  _adc_kernel_cps``): a cp.async ring of ``depth`` slot stages,
  ``slots_per_step`` slots per step, batched or per-slot waits, branchless
  or not, ``copies`` copies of the LUT in shared memory, wide or per-slot
  minimum output;
- :func:`scan_compute_only` (L3 ``:207 _adc_kernel_nodma``): the pipelined
  kernel's lookups against one staged tile, no code copies in the loop;
- :func:`scan_copy_only` (L3 ``:236 _adc_kernel_dmaonly``): its copy
  pipeline with a byte sum in place of the lookups.

They take the production scan's inputs (``ops/cuda/adc_scan.py``: LUTs,
norm table, the flat store, the slot schedule) and a :class:`Variant` of
:data:`VARIANTS`, which names the compiled instantiation. The full-function
variants compute :func:`adc_scan_slots_plain`'s function (or its per-slot
minimum) and equal ``adc_scan_slots`` / ``adc_scan_slots_min`` bit for bit,
except the skew variants: they add a lane's rows in the rotated order of
:func:`lane_row` (``adc_scan_slots_plain(..., rotate=True)``, which they
equal bit for bit) and agree with production within f32 rounding (rtol
1e-4, atol 1e-3).

What bounds them on an H100: per valid lane M+1 code bytes and M+1 random
shared-memory lookups, plus 4 B per lane of the wide output. The variants
exist to tell those apart on the card (compute-only and copy-only subtract
from the full kernel at equal occupancy; ``copies`` spreads the lookups over
more banks); see ``tools/kernel_lab.py`` for the sweep and ``PERF.md`` for
what it found. Nothing on the search path calls them.

CPU tensors go to the plain versions. CUDA tensors launch the kernel on the
current stream, or raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ivfhnsw_tpu_torch.ops.cuda.adc_scan import (CHUNK, KSUB, RCHUNK, _check,
                                                 adc_scan_slots_min_plain,
                                                 adc_scan_slots_plain)

LAB = "tools/kernel_lab.py"
PALLAS = "ivfhnsw_tpu/ops/pallas/adc_scan.py"


@dataclass(frozen=True)
class Variant:
    """One compiled instantiation of ``csrc/scan_lab.cu``: entry point
    ``ivf_lab_<name>``, the kernel family (``kind``: "direct", "skew",
    "runs", "pipelined", "compute_only", "copy_only"), its slot width, LUT
    copies, ring depth, slots per step, wait placement, branchless flag and
    epilogue ("wide" or "min"), and the TPU rig it answers (``file:line``)."""

    name: str
    kind: str
    gran: int
    replaces: str
    copies: int = 1
    depth: int = 2
    slots_per_step: int = 1
    batched_wait: bool = False
    branchless: bool = False
    epilogue: str = "wide"

    @property
    def full(self) -> bool:
        """Computes the production scan's function (or its slot minima)."""
        return self.kind in ("direct", "skew", "runs", "pipelined")


def _pipe(name, gran, replaces, **kw):
    return Variant(name, "pipelined", gran, replaces, **kw)


# The sweep: at 256, L4's steps x depth (d8/s2 the reference; d2/s1 reaches
# the production kernel's 8 blocks per SM at M=16), L3's v1b,
# 8 LUT copies, and the compute-only / copy-only decomposition of the
# reference; at 1024, L2's LUT copies, branchless and depth (d2/s1 the
# reference), its decomposition, and L1's bulk-copy runs; then K1-K4 as first
# ported (direct) and over a bank-skewed LUT (skew).
VARIANTS = {v.name: v for v in (
    _pipe("pipe256_c1_d8_s2", CHUNK, f"{LAB}:694", depth=8,
          slots_per_step=2),
    _pipe("pipe256_c1_d16_s4", CHUNK, f"{LAB}:694", depth=16,
          slots_per_step=4),
    _pipe("pipe256_c1_d2_s1", CHUNK, f"{LAB}:694"),
    _pipe("pipe256_c1_d16_s4_bw", CHUNK, f"{LAB}:285", depth=16,
          slots_per_step=4, batched_wait=True),
    _pipe("pipe256_c8_d8_s2", CHUNK, f"{LAB}:694", copies=8, depth=8,
          slots_per_step=2),
    _pipe("pipe256_c1_d8_s2_min", CHUNK, f"{LAB}:694", depth=8,
          slots_per_step=2, epilogue="min"),
    _pipe("pipe256_c8_d8_s2_min", CHUNK, f"{LAB}:694", copies=8, depth=8,
          slots_per_step=2, epilogue="min"),
    Variant("comp256_wide", "compute_only", CHUNK, f"{LAB}:207", depth=8,
            slots_per_step=2),
    Variant("comp256_min", "compute_only", CHUNK, f"{LAB}:207", depth=8,
            slots_per_step=2, epilogue="min"),
    Variant("copy256_wide", "copy_only", CHUNK, f"{LAB}:236", depth=8,
            slots_per_step=2),
    Variant("copy256_min", "copy_only", CHUNK, f"{LAB}:236", depth=8,
            slots_per_step=2, epilogue="min"),
    _pipe("pipe1024_c1_d2_s1", RCHUNK, f"{LAB}:525"),
    _pipe("pipe1024_c4_d2_s1", RCHUNK, f"{LAB}:525", copies=4),
    _pipe("pipe1024_c8_d2_s1", RCHUNK, f"{LAB}:525", copies=8),
    _pipe("pipe1024_c1_d2_s1_nb", RCHUNK, f"{LAB}:449", branchless=True),
    _pipe("pipe1024_c1_d4_s2", RCHUNK, f"{LAB}:525", depth=4,
          slots_per_step=2),
    _pipe("pipe1024_c1_d2_s1_min", RCHUNK, f"{LAB}:525", epilogue="min"),
    _pipe("pipe1024_c8_d2_s1_min", RCHUNK, f"{LAB}:525", copies=8,
          epilogue="min"),
    Variant("comp1024_wide", "compute_only", RCHUNK, f"{LAB}:207"),
    Variant("comp1024_min", "compute_only", RCHUNK, f"{LAB}:207",
            epilogue="min"),
    Variant("copy1024_wide", "copy_only", RCHUNK, f"{LAB}:236"),
    Variant("copy1024_min", "copy_only", RCHUNK, f"{LAB}:236",
            epilogue="min"),
    Variant("runs1024_d2", "runs", RCHUNK, f"{LAB}:87"),
    Variant("runs1024_d4", "runs", RCHUNK, f"{LAB}:87", depth=4),
    Variant("direct256", "direct", CHUNK, f"{PALLAS}:216"),
    Variant("direct1024", "direct", RCHUNK, f"{PALLAS}:368"),
    Variant("direct256_min", "direct", CHUNK, f"{PALLAS}:545",
            epilogue="min"),
    Variant("direct1024_min", "direct", RCHUNK, f"{PALLAS}:685",
            epilogue="min"),
    Variant("skew256", "skew", CHUNK, f"{PALLAS}:216"),
    Variant("skew1024", "skew", RCHUNK, f"{PALLAS}:368"),
    Variant("skew256_min", "skew", CHUNK, f"{PALLAS}:545", epilogue="min"),
    Variant("skew1024_min", "skew", RCHUNK, f"{PALLAS}:685", epilogue="min"),
)}

# Launches per entry point, counted where each wrapper launches.
LAUNCHES = {name: 0 for name in VARIANTS}


# ---- the bank-skewed LUT: the skew kernels' addressing ----------------------

BANKS = 32     # 4-byte shared-memory banks of an SM, and lanes of a warp


def skewed(M: int) -> bool:
    """Whether the skew kernels exist at ``M`` subquantizers: M divides the
    32 banks and a code row is whole 4-byte words."""
    return M in (4, 8, 16, 32)


def skew_word(k: int, m: int, c: int, M: int) -> int:
    """The skew kernels' shared-memory LUT layout, as their specification:
    the 4-byte word that holds entry ``k`` of LUT row ``m`` in copy ``c``
    of the C = 32 // M interleaved copies. Row m of copy c lives in bank
    m * C + c alone, and the table takes 256 * 32 words at every M."""
    C = BANKS // max(M, 1)
    if not (skewed(M) and 0 <= k < KSUB and 0 <= m < M and 0 <= c < C):
        raise ValueError(f"skew_word: no word for k={k} m={m} c={c} M={M}")
    return k * BANKS + m * C + c


def lane_copy(l: int, M: int) -> int:
    """The LUT copy that lane ``l`` of a slot reads: (l // M) mod (32 // M)."""
    return (l // M) % (BANKS // M)


def lane_row(l: int, t: int, M: int) -> int:
    """The LUT row (and code byte) that lane ``l`` of a slot adds at step
    ``t`` = 0..M-1, after bias + norm: (t + l) mod M. The 32 lanes of a
    warp hold 32 consecutive ``l``, hence every pair (l mod M,
    :func:`lane_copy`) once, so at each step they read 32 different
    (row, copy) pairs: 32 different banks, whatever the codes."""
    return (t + l) % M


# ---- plain versions --------------------------------------------------------

def _slot_rows(start: torch.Tensor, length: torch.Tensor, gran: int):
    """Store row of every lane (0 where l >= len) and the lane mask, both
    [B, S*gran]."""
    B, S = start.shape
    lane = torch.arange(gran, device=start.device)
    valid = lane < length.long()[:, :, None]
    row = torch.where(valid, start[:, :, None] + lane, 0)
    return row.reshape(B, S * gran), valid.reshape(B, S * gran)


def _epilogue(out: torch.Tensor, v: Variant, S: int) -> torch.Tensor:
    """[B, S*gran] lanes -> themselves (wide) or their slot minima (min)."""
    if v.epilogue == "min":
        return out.view(out.shape[0], S, v.gran).amin(dim=-1)
    return out


def scan_full_plain(lut, norm_tab, codes, norm_codes, start, length, bias,
                    v: Variant) -> torch.Tensor:
    """Plain version of :func:`scan_direct`, :func:`scan_skew`,
    :func:`scan_runs` and :func:`scan_pipelined`: the production scan's
    function at ``v.gran``, wide or per-slot minimum; for a skew variant
    summed in the rotated order of :func:`lane_row`."""
    plain = adc_scan_slots_min_plain if v.epilogue == "min" else (
        adc_scan_slots_plain)
    return plain(lut, norm_tab, codes, norm_codes, start, length, bias,
                 v.gran, rotate=v.kind == "skew")


def scan_compute_only_plain(lut, norm_tab, codes, norm_codes, start, length,
                            bias, v: Variant, tile_row: int = 0
                            ) -> torch.Tensor:
    """Plain version of :func:`scan_compute_only`: lane l < len[b,s] of
    every slot holds the raw sum norm_tab[n_r] + sum_m lut[b,m,c_{r,m}] of
    row r = tile_row + l (no bias), +inf elsewhere; wide or per-slot
    minimum. ``bias`` is unused."""
    B, S = start.shape
    gran = v.gran
    rows = tile_row + torch.arange(gran, device=start.device)
    acc = norm_tab[norm_codes[rows].long()].expand(B, gran)
    for m in range(codes.shape[1]):
        acc = acc + lut[:, m, codes[rows, m].long()]
    lane = torch.arange(gran, device=start.device)
    valid = lane < length.long()[:, :, None]
    out = torch.where(valid, acc[:, None, :], float("inf"))
    return _epilogue(out.reshape(B, S * gran), v, S)


def scan_copy_only_plain(lut, norm_tab, codes, norm_codes, start, length,
                         bias, v: Variant) -> torch.Tensor:
    """Plain version of :func:`scan_copy_only`: lane l < len[b,s] holds
    norm_codes[r] + sum_m codes[r, m] as f32 (r = start[b,s] + l), +inf
    elsewhere; wide or per-slot minimum. ``lut``, ``norm_tab`` and ``bias``
    are unused."""
    B, S = start.shape
    if codes.shape[0] == 0:
        return _epilogue(torch.full((B, S * v.gran), float("inf"),
                                    device=start.device), v, S)
    row, valid = _slot_rows(start, length, v.gran)
    acc = norm_codes[row].float()
    for m in range(codes.shape[1]):
        acc = acc + codes[row, m].float()
    return _epilogue(torch.where(valid, acc, float("inf")), v, S)


# ---- kernels ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``ivf_lab_<name>`` (built at first use): 8
    pointers, B, nslots, M, N, tile_row, smem_floor, the stream, info."""
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = getattr(load_library("scan_lab"), f"ivf_lab_{name}")
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def occupancy(v: Variant, M: int, smem_floor: int = 0) -> tuple[int, int]:
    """(blocks per SM, dynamic shared-memory bytes) of ``v``'s kernel at
    ``M`` subquantizers on the current CUDA device, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    info = (ctypes.c_int * 2)()
    rc = _entry(v.name)(*([None] * 8), 0, 0, M, 0, 0, smem_floor, None, info)
    if rc != 0:
        raise RuntimeError(f"{v.name}: occupancy query failed with CUDA "
                           f"error {rc}")
    return int(info[0]), int(info[1])


def _lab_scan(wrapper, kinds: tuple, plain, v: Variant, args: tuple,
              tile_row: int = 0, smem_floor: int = 0) -> torch.Tensor:
    """Check the arguments of lab wrapper ``wrapper`` and variant ``v``,
    then run ``plain`` on CPU tensors, or on CUDA tensors launch
    ``ivf_lab_<v.name>`` into a new output (raising if the launch fails) and
    count the launch in :data:`LAUNCHES`."""
    fn = wrapper.__name__
    if v.kind not in kinds or VARIANTS.get(v.name) != v:
        raise ValueError(f"{fn}: {v} is not one of its variants")
    lut, norm_tab, codes, norm_codes, start, length, bias = args
    B, S = start.shape
    N, M = codes.shape
    dev = lut.device
    for name, t, dtype, shape in (
            ("lut", lut, torch.float32, (B, M, KSUB)),
            ("norm_tab", norm_tab, torch.float32, (KSUB,)),
            ("codes", codes, torch.uint8, (N, M)),
            ("norm_codes", norm_codes, torch.uint8, (N,)),
            ("start", start, torch.int64, (B, S)),
            ("length", length, torch.int32, (B, S)),
            ("bias", bias, torch.float32, (B, S))):
        _check(name, t, dtype, shape, dev, fn)
    if max(B, S, M) >= 2 ** 31 or M == 0:
        raise ValueError(f"{fn}: unsupported sizes B={B} S={S} M={M}")
    if v.kind == "skew" and not skewed(M):
        raise ValueError(f"{fn}: the skew kernels need M in 4, 8, 16, 32, "
                         f"got {M}")
    if v.kind == "compute_only" and not 0 <= tile_row <= N - v.gran:
        raise ValueError(f"{fn}: tile rows [{tile_row}, {tile_row + v.gran})"
                         f" outside the store's {N} rows")
    if dev.type == "cpu":
        if v.kind == "compute_only":
            return plain(*args, v, tile_row)
        return plain(*args, v)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    for name, t in (("codes", codes), ("norm_codes", norm_codes)):
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    cols = S if v.epilogue == "min" else S * v.gran
    out = torch.empty((B, cols), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry(v.name)(*(t.data_ptr() for t in args), out.data_ptr(),
                            B, S, M, N, tile_row, smem_floor, stream, None)
    if rc != 0:
        raise RuntimeError(f"{fn} {v.name}: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES[v.name] += 1
    return out


def scan_direct(lut, norm_tab, codes, norm_codes, start, length, bias,
                v: Variant, smem_floor: int = 0) -> torch.Tensor:
    """K1-K4 as first ported (``v.kind == "direct"``): [B,
    S*gran] f32, or with ``v.epilogue == "min"`` [B, S] slot minima, equal
    to :func:`scan_full_plain`. Arguments as :func:`scan_runs`."""
    return _lab_scan(scan_direct, ("direct",), scan_full_plain, v,
                     (lut, norm_tab, codes, norm_codes, start, length, bias),
                     smem_floor=smem_floor)


def scan_skew(lut, norm_tab, codes, norm_codes, start, length, bias,
              v: Variant, smem_floor: int = 0) -> torch.Tensor:
    """K1-K4 over a bank-skewed LUT (``v.kind == "skew"``; M in 4, 8, 16,
    32): [B, S*gran] f32, or with ``v.epilogue == "min"`` [B, S] slot
    minima, equal to :func:`scan_full_plain` (the rotated order).
    Arguments as :func:`scan_runs`."""
    return _lab_scan(scan_skew, ("skew",), scan_full_plain, v,
                     (lut, norm_tab, codes, norm_codes, start, length, bias),
                     smem_floor=smem_floor)


def scan_runs(lut, norm_tab, codes, norm_codes, start, length, bias,
              v: Variant, smem_floor: int = 0) -> torch.Tensor:
    """L1: the scan at 1024-code slots with one TMA bulk copy per slot
    (``v.kind == "runs"``); [B, S*1024] f32, equal to
    :func:`scan_full_plain`.
    Arguments as ``adc_scan_slots`` (codes and norm_codes 16-byte aligned
    on the card); ``smem_floor`` raises the launch's shared memory (to
    compare at a lower occupancy)."""
    return _lab_scan(scan_runs, ("runs",), scan_full_plain, v,
                     (lut, norm_tab, codes, norm_codes, start, length, bias),
                     smem_floor=smem_floor)


def scan_pipelined(lut, norm_tab, codes, norm_codes, start, length, bias,
                   v: Variant, smem_floor: int = 0) -> torch.Tensor:
    """L2 / L3's v1b / L4: the scan through a cp.async ring
    (``v.kind == "pipelined"``); [B, S*gran] f32, or with
    ``v.epilogue == "min"`` [B, S] slot minima, equal to
    :func:`scan_full_plain`. Arguments as :func:`scan_runs`."""
    return _lab_scan(scan_pipelined, ("pipelined",), scan_full_plain, v,
                     (lut, norm_tab, codes, norm_codes, start, length, bias),
                     smem_floor=smem_floor)


def scan_compute_only(lut, norm_tab, codes, norm_codes, start, length, bias,
                      v: Variant, tile_row: int = 0) -> torch.Tensor:
    """L3's nodma: the pipelined kernel's lookups with no code copies in the
    slot loop, against store rows [tile_row, tile_row + gran) staged once
    (see :func:`scan_compute_only_plain`). Requires tile_row + gran <= N."""
    return _lab_scan(scan_compute_only, ("compute_only",),
                     scan_compute_only_plain, v,
                     (lut, norm_tab, codes, norm_codes, start, length, bias),
                     tile_row=tile_row)


def scan_copy_only(lut, norm_tab, codes, norm_codes, start, length, bias,
                   v: Variant) -> torch.Tensor:
    """L3's dmaonly: the pipelined kernel's copies, with a byte sum in place
    of the lookups (see :func:`scan_copy_only_plain`)."""
    return _lab_scan(scan_copy_only, ("copy_only",), scan_copy_only_plain,
                     v, (lut, norm_tab, codes, norm_codes, start, length,
                         bias))


# Wrapper and plain version of each kind.
FUNCTIONS = {
    "direct": (scan_direct, scan_full_plain),
    "skew": (scan_skew, scan_full_plain),
    "runs": (scan_runs, scan_full_plain),
    "pipelined": (scan_pipelined, scan_full_plain),
    "compute_only": (scan_compute_only, scan_compute_only_plain),
    "copy_only": (scan_copy_only, scan_copy_only_plain),
}


def reset_launches() -> None:
    """Set every lab launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
