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

Beside them, the min-scan steps (:data:`MIN_STEPS`, :func:`scan_min_step`,
:data:`MIN_LAUNCHES`): the design steps of the production min kernel
(K3/K4, ``csrc/min_scan.cuh``) from the first port (step ``first_port``,
``direct_min_kernel``) on, each a kernel of its own so that
``tools/min_probe.py`` can time it against the first port in turns and
count its machine instructions; ``comp*`` and ``loads*`` take a design's
time apart (no code loads in the lane loop; no lookups).

The wide-scan steps (:data:`WIDE_STEPS`, :func:`scan_wide_step`,
:data:`WIDE_LAUNCHES`) do the same for the production wide kernel (K1/K2,
``csrc/wide_scan.cuh``) from its first port (step ``first_port``,
``direct_wide_kernel``) on; ``stores``, ``noout``, ``comp`` and ``loads``
(and their ``warp_*`` twins, the production setting's) take a design's
time apart: its stores alone, its loop without the output, its lookups
alone, its code reads alone.

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


# ---- the min-scan steps ------------------------------------------------------

@dataclass(frozen=True)
class MinStep:
    """One step of ``csrc/scan_lab.cu::ivf_lab_mstep``: its id there, the
    kernel's name in the library (``direct_min_kernel`` or
    ``mstep_<name>``), the switches of ``csrc/min_scan.cuh::body`` it sets
    (``addr`` "shift" / "prmt" / "dp4a", ``off32``, codes per lane per step
    ``cps``, ``stage`` "loop" / "vec" / "tma", prefetch ``pf``,
    ``min_blocks`` of its launch bounds) and ``mode``: "full" (the
    production function), "compute" (no code loads in the lane loop: each
    lane's first row of the slot, so the minimum of the slot's first 32
    lanes) or "loads" (no lookups: the minimum of the row words' xor,
    :func:`min_step_plain`)."""

    name: str
    step: int
    addr: str = "shift"
    off32: bool = False
    cps: int = 1
    stage: str = "loop"
    pf: bool = False
    mode: str = "full"
    min_blocks: int = 1

    @property
    def kernel(self) -> str:
        return ("direct_min_kernel" if self.step == 0
                else f"mstep_{self.name}")


# Step 0 is the first port and steps 1-2 split its time (compute only,
# loads only); steps 3-10 add one switch each (prmt, off32, two codes a
# step, 16-byte staging, TMA staging, DP4A addressing, both, 8 blocks a
# SM); 14 is the production setting (DP4A, one code a step, TMA staging, 8
# blocks a SM) and 11-12 split its time; 13 loads the next step's rows
# ahead, an open lead for sparse schedules over stores larger than L2.
# PERF.md holds the readings of the steps no longer built (four codes a
# step, two warps a slot, other prefetch and register settings).
_TWO = dict(addr="prmt", off32=True, cps=2, stage="vec")
_DP4A_TMA = dict(_TWO, addr="dp4a", stage="tma")
_PROD = dict(addr="dp4a", off32=True, stage="tma", min_blocks=8)
MIN_STEPS = {s.name: s for s in (
    MinStep("first_port", 0),
    MinStep("comp", 1, mode="compute"),
    MinStep("loads", 2, mode="loads"),
    MinStep("prmt", 3, addr="prmt"),
    MinStep("off32", 4, addr="prmt", off32=True),
    MinStep("two", 5, addr="prmt", off32=True, cps=2),
    MinStep("stage16", 6, **_TWO),
    MinStep("tma", 7, **{**_TWO, "stage": "tma"}),
    MinStep("dp4a", 8, **{**_TWO, "addr": "dp4a"}),
    MinStep("dp4a_tma", 9, **_DP4A_TMA),
    MinStep("dp4a_tma_b8", 10, **_DP4A_TMA, min_blocks=8),
    MinStep("comp_new", 11, **_PROD, mode="compute"),
    MinStep("loads_new", 12, **_PROD, mode="loads"),
    MinStep("dp4a_pf_b6", 13, **{**_TWO, "addr": "dp4a"}, pf=True,
            min_blocks=6),
    MinStep("dp4a1_tma_b8", 14, **_PROD),
)}
MIN_LAUNCHES = {name: 0 for name in MIN_STEPS}
# The step whose switches csrc/adc_scan.cu's adc_scan_slots_min_kernel
# instantiates (tests/test_torch_min_kernel.py holds the two together).
PRODUCTION_STEP = "dp4a1_tma_b8"


def _check_step_args(fn: str, args: tuple, gran: int):
    """Raise unless ``args`` (the production scan's seven inputs) and
    ``gran`` are what step wrapper ``fn``'s kernels take; returns (B, S,
    N, M, device)."""
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
    if gran <= 0 or max(B, S, M, gran) >= 2 ** 31 or M == 0:
        raise ValueError(f"{fn}: unsupported sizes B={B} S={S} M={M} "
                         f"gran={gran}")
    return B, S, N, M, dev


def _row_xor(codes: torch.Tensor, norm_codes: torch.Tensor) -> torch.Tensor:
    """The LOADS modes' value of every store row (M = 16): (w0 ^ w1 ^ w2 ^
    w3 ^ norm_codes[r]) & 0xffffff, w_q the little-endian word of code
    bytes 4q..4q+3, int64 [N]."""
    b = codes.long()
    words = [b[:, 4 * q] | b[:, 4 * q + 1] << 8 | b[:, 4 * q + 2] << 16
             | b[:, 4 * q + 3] << 24 for q in range(4)]
    return (words[0] ^ words[1] ^ words[2] ^ words[3] ^ norm_codes.long()
            ) & 0xFFFFFF


def min_step_plain(lut, norm_tab, codes, norm_codes, start, length, bias,
                   gran: int, step: MinStep) -> torch.Tensor:
    """Plain version of :func:`scan_min_step`, [B, S] f32: for a "full"
    step ``adc_scan_slots_min_plain``; for "compute" the same over each
    slot's first 32 lanes; for "loads" the minimum over the
    slot's rows r of (w0 ^ w1 ^ w2 ^ w3 ^ norm_codes[r]) & 0xffffff as f32,
    w_q the little-endian word of code bytes 4q..4q+3 (M = 16), +inf for an
    empty slot."""
    if step.mode == "full":
        return adc_scan_slots_min_plain(lut, norm_tab, codes, norm_codes,
                                        start, length, bias, gran)
    if codes.shape[1] != 16:
        raise ValueError(f"min step {step.name}: needs M = 16, got "
                         f"{codes.shape[1]}")
    if step.mode == "compute":
        return adc_scan_slots_min_plain(
            lut, norm_tab, codes, norm_codes, start, length.clamp(max=32),
            bias, gran)
    B, S = start.shape
    if codes.shape[0] == 0:
        return torch.full((B, S), float("inf"), device=start.device)
    row, valid = _slot_rows(start, length.clamp(max=gran), gran)
    val = torch.where(valid, _row_xor(codes, norm_codes)[row].float(),
                      float("inf"))
    return val.view(B, S, gran).amin(dim=-1)


@functools.lru_cache(maxsize=None)
def _mstep_entry():
    """``ivf_lab_mstep`` (built at first use): the step, 8 pointers, B,
    nslots, M, gran, the stream, info."""
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = load_library("scan_lab").ivf_lab_mstep
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def min_step_occupancy(step: MinStep, M: int) -> tuple[int, int, int]:
    """(blocks per SM, dynamic shared-memory bytes, registers a thread) of
    ``step``'s kernel at ``M`` subquantizers on the current CUDA device."""
    info = (ctypes.c_int * 3)()
    rc = _mstep_entry()(step.step, *([None] * 8), 0, 0, M, CHUNK, None,
                        info)
    if rc != 0:
        raise RuntimeError(f"min step {step.name}: occupancy query failed "
                           f"with CUDA error {rc}")
    return int(info[0]), int(info[1]), int(info[2])


def scan_min_step(lut, norm_tab, codes, norm_codes, start, length, bias,
                  gran: int, step: MinStep) -> torch.Tensor:
    """Min-scan step ``step`` (one of :data:`MIN_STEPS`) on the production
    scan's inputs at slot width ``gran``: [B, S] f32, equal to
    :func:`min_step_plain` (a "full" step: to ``adc_scan_slots_min``, bit
    for bit). "compute" and "loads" steps need M = 16. CPU tensors go to
    the plain version; CUDA tensors launch the step's kernel on the current
    stream, or raise; :data:`MIN_LAUNCHES` counts the launches."""
    fn = "scan_min_step"
    if MIN_STEPS.get(step.name) != step:
        raise ValueError(f"{fn}: {step} is not one of MIN_STEPS")
    args = (lut, norm_tab, codes, norm_codes, start, length, bias)
    B, S, N, M, dev = _check_step_args(fn, args, gran)
    if step.mode != "full" and M != 16:
        raise ValueError(f"{fn}: step {step.name} needs M = 16, got {M}")
    if dev.type == "cpu":
        return min_step_plain(*args, gran, step)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if step.mode != "full" and codes.data_ptr() % 16:
        raise ValueError(f"{fn}: step {step.name} needs 16-byte aligned "
                         "codes")
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _mstep_entry()(step.step, *(t.data_ptr() for t in args),
                            out.data_ptr(), B, S, M, gran, stream, None)
    if rc != 0:
        raise RuntimeError(f"{fn} {step.name}: kernel launch failed with "
                           f"CUDA error {rc}")
    MIN_LAUNCHES[step.name] += 1
    return out


# ---- the wide-scan steps -----------------------------------------------------

WIDE_THREADS = 256     # threads a block of csrc/wide_scan.cuh
WIDE_WARPS = WIDE_THREADS // 32
SM_SMEM = 233_472      # shared memory of an H100 SM, bytes
SM_BLOCK_RESERVED = 1024   # shared memory the card keeps for each block
SM_THREADS = 2048      # threads an H100 SM holds


@dataclass(frozen=True)
class WideStep:
    """One step of ``csrc/scan_lab.cu::ivf_lab_wstep``: its id there, the
    kernel's name in the library (``direct_wide_kernel`` or
    ``wstep_<name>``), the switches of ``csrc/wide_scan.cuh::body`` it sets
    (``addr`` "shift" / "dp4a", ``layout`` "block" (the first port's: all
    threads on one slot at a time) / "warp" (a warp a slot), ``stage``
    "loop" / "tma", ``out`` "plain" / "stream", ``min_blocks`` of its
    launch bounds) and ``mode``: "full" (the production function), "stores"
    (bias in each valid lane), "noout" (each thread's minimum, [B, 256]),
    "compute" (each lane looks up a constant store row) or "loads" (the row
    words' xor), all defined by :func:`wide_step_plain`."""

    name: str
    step: int
    addr: str = "shift"
    layout: str = "block"
    stage: str = "loop"
    out: str = "plain"
    mode: str = "full"
    min_blocks: int = 1

    @property
    def kernel(self) -> str:
        return ("direct_wide_kernel" if self.step == 0
                else f"wstep_{self.name}")


# Step 0 is the first port; 1-4 split its time (stores only, no output,
# lookups only, code reads only) at its 8 blocks an SM; 5 is its stores as
# production had them before the redesign, 6 adds one IDP.4A a lookup and
# TMA staging (production at 1024 codes); 7-8 give each warp its own
# slots (the structure alone, then with the new lookup: production below
# 1024 codes); 9-12 split step 8. PERF.md holds the readings of the steps
# no longer built (four lanes a thread, bulk stores of shared-memory
# tiles, persistent blocks, early fills of empty slots, 16-byte tail
# stores, and combinations of them).
_B8 = dict(min_blocks=8)
_WARP = dict(addr="dp4a", stage="tma", out="stream", layout="warp",
             min_blocks=8)
WIDE_STEPS = {s.name: s for s in (
    WideStep("first_port", 0),
    WideStep("stores", 1, mode="stores", **_B8),
    WideStep("noout", 2, mode="noout", **_B8),
    WideStep("comp", 3, mode="compute", **_B8),
    WideStep("loads", 4, mode="loads", **_B8),
    WideStep("stream", 5, out="stream", **_B8),
    WideStep("dp4a", 6, addr="dp4a", stage="tma", out="stream", **_B8),
    WideStep("warp_shift", 7, layout="warp", out="stream", **_B8),
    WideStep("warp", 8, **_WARP),
    WideStep("warp_stores", 9, **_WARP, mode="stores"),
    WideStep("warp_noout", 10, **_WARP, mode="noout"),
    WideStep("warp_comp", 11, **_WARP, mode="compute"),
    WideStep("warp_loads", 12, **_WARP, mode="loads"),
)}
WIDE_LAUNCHES = {name: 0 for name in WIDE_STEPS}
# The steps whose switches csrc/adc_scan.cu's two production wide kernels
# instantiate, by kernel: a warp a slot below WARP_GRAN_BELOW codes, the
# block a slot at and above it (tests/test_torch_wide_kernel.py holds them
# together).
WARP_GRAN_BELOW = 1024
WIDE_PRODUCTION = {"adc_scan_slots_kernel_warp": "warp",
                   "adc_scan_slots_kernel_block": "dp4a"}


def wide_production_step(gran: int) -> WideStep:
    """The step that ``adc_scan_slots`` runs at slot width ``gran``."""
    return WIDE_STEPS["warp" if gran < WARP_GRAN_BELOW else "dp4a"]


def wide_smem_bytes(step: WideStep, M: int) -> int:
    """Dynamic shared memory of ``step``'s launch at ``M`` subquantizers:
    the tables and, but for the first port, min_scan.cuh's mbarrier."""
    return (M + 1) * KSUB * 4 + (16 if step.step else 0)


def smem_blocks_per_sm(smem: int) -> int:
    """Blocks of 256 threads an H100 SM holds at ``smem`` bytes of dynamic
    shared memory each, by shared memory and threads alone (registers can
    hold it lower)."""
    return min(SM_THREADS // WIDE_THREADS,
               SM_SMEM // (smem + SM_BLOCK_RESERVED))


def wide_owner(step: WideStep, S: int, gran: int,
               device="cpu") -> torch.Tensor:
    """[S, gran] the thread (0..255) of a query's block that computes lane
    l of slot s: l mod 256 in the block layout; in the warp layout warp s
    mod 8, its lane l mod 32."""
    s = torch.arange(S, device=device)[:, None]
    lane = torch.arange(gran, device=device)[None, :]
    if step.layout == "block":
        return (lane % WIDE_THREADS).expand(S, gran)
    return (s % WIDE_WARPS) * 32 + lane % 32


def _lane_sums(lut, norm_tab, codes, norm_codes, row, bias_lane):
    """bias_lane + norm_tab[norm_codes[row]] + sum_m lut[b, m, codes[row,
    m]] in that order, for store rows ``row`` [B, L] (the kernels' order)."""
    B, M = lut.shape[0], codes.shape[1]
    flat = lut.reshape(B, M * KSUB)
    acc = bias_lane + norm_tab[norm_codes[row].long()]
    for m in range(M):
        acc = acc + torch.gather(flat, 1, m * KSUB + codes[row, m].long())
    return acc


def wide_step_plain(lut, norm_tab, codes, norm_codes, start, length, bias,
                    gran: int, step: WideStep) -> torch.Tensor:
    """Plain version of :func:`scan_wide_step`. [B, S*gran] f32, +inf in
    every lane l >= len[b, s]; in lane l < len[b, s]: for a "full" step
    ``adc_scan_slots_plain``; "stores" bias[b, s]; "loads" (w0 ^ w1 ^ w2 ^
    w3 ^ norm_codes[r]) & 0xffffff as f32, w_q the little-endian word of
    code bytes 4q..4q+3 of row r = start[b, s] + l; "compute" the sum of
    store row l mod 32 in the production order. "noout": [B, 256],
    column t the minimum of the full output over the lanes thread t owns
    (:func:`wide_owner`), +inf where it owns none that is valid."""
    B, S = start.shape
    mode = step.mode
    if mode in ("full", "noout"):
        out = adc_scan_slots_plain(lut, norm_tab, codes, norm_codes, start,
                                   length, bias, gran)
        if mode == "full":
            return out
        idx = wide_owner(step, S, gran, start.device).reshape(1, S * gran)
        fold = torch.full((B, WIDE_THREADS), float("inf"),
                          device=start.device)
        return fold.scatter_reduce(1, idx.expand(B, -1), out, "amin")
    lane = torch.arange(gran, device=start.device)
    valid = (lane < length.long()[:, :, None]).reshape(B, S * gran)
    if mode == "stores":
        val = bias.repeat_interleave(gran, dim=1)
    elif mode == "compute":
        if codes.shape[1] != 16 or codes.shape[0] < 32:
            raise ValueError(f"wide step {step.name}: needs M = 16 and 32 "
                             f"store rows, got {tuple(codes.shape)}")
        row = (lane % 32).repeat(S).expand(B, -1)
        val = _lane_sums(lut, norm_tab, codes, norm_codes, row,
                         bias.repeat_interleave(gran, dim=1))
    else:
        if codes.shape[1] != 16:
            raise ValueError(f"wide step {step.name}: needs M = 16, got "
                             f"{codes.shape[1]}")
        if codes.shape[0] == 0:
            return torch.full((B, S * gran), float("inf"),
                              device=start.device)
        row, _ = _slot_rows(start, length.clamp(max=gran), gran)
        val = _row_xor(codes, norm_codes)[row].float()
    return torch.where(valid, val, float("inf"))


@functools.lru_cache(maxsize=None)
def _wstep_entry():
    """``ivf_lab_wstep`` (built at first use): the step, 8 pointers, B,
    nslots, M, gran, the stream, info."""
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = load_library("scan_lab").ivf_lab_wstep
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def wide_step_occupancy(step: WideStep, M: int) -> tuple[int, int, int]:
    """(blocks per SM, dynamic shared-memory bytes, registers a thread) of
    ``step``'s kernel at ``M`` subquantizers on the current CUDA device."""
    info = (ctypes.c_int * 3)()
    rc = _wstep_entry()(step.step, *([None] * 8), 0, 0, M, CHUNK, None,
                        info)
    if rc != 0:
        raise RuntimeError(f"wide step {step.name}: occupancy query failed "
                           f"with CUDA error {rc}")
    return int(info[0]), int(info[1]), int(info[2])


def scan_wide_step(lut, norm_tab, codes, norm_codes, start, length, bias,
                   gran: int, step: WideStep) -> torch.Tensor:
    """Wide-scan step ``step`` (one of :data:`WIDE_STEPS`) on the
    production scan's inputs at slot width ``gran``: equal to
    :func:`wide_step_plain` (a "full" step: to ``adc_scan_slots``, bit for
    bit). "compute" and "loads" steps need M = 16 ("compute" 32 store
    rows). CPU tensors go to the plain version; CUDA tensors launch the
    step's kernel on the current stream, or raise; :data:`WIDE_LAUNCHES`
    counts the launches."""
    fn = "scan_wide_step"
    if WIDE_STEPS.get(step.name) != step:
        raise ValueError(f"{fn}: {step} is not one of WIDE_STEPS")
    args = (lut, norm_tab, codes, norm_codes, start, length, bias)
    B, S, N, M, dev = _check_step_args(fn, args, gran)
    if step.mode in ("compute", "loads") and M != 16:
        raise ValueError(f"{fn}: step {step.name} needs M = 16, got {M}")
    if step.mode == "compute" and N < 32:
        raise ValueError(f"{fn}: step {step.name} needs 32 store rows, "
                         f"got {N}")
    if dev.type == "cpu":
        return wide_step_plain(*args, gran, step)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if step.mode in ("compute", "loads") and codes.data_ptr() % 16:
        raise ValueError(f"{fn}: step {step.name} needs 16-byte aligned "
                         "codes")
    cols = WIDE_THREADS if step.mode == "noout" else S * gran
    out = torch.empty((B, cols), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _wstep_entry()(step.step, *(t.data_ptr() for t in args),
                            out.data_ptr(), B, S, M, gran, stream, None)
    if rc != 0:
        raise RuntimeError(f"{fn} {step.name}: kernel launch failed with "
                           f"CUDA error {rc}")
    WIDE_LAUNCHES[step.name] += 1
    return out


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
    """Set every lab launch count to 0 (the min-scan and wide-scan steps'
    too)."""
    for counts in (LAUNCHES, MIN_LAUNCHES, WIDE_LAUNCHES):
        for name in counts:
            counts[name] = 0
