"""Fused IVFADC search engine (``engine="fused"``) around the hand-written
ADC scan kernels of ``csrc/adc_scan.cu``.

Counterpart of ``ivfhnsw_tpu/ops/pallas/adc_scan.py::pallas_search_core``.
The steps:

1. coarse top-``nprobe``, ascending (:func:`select_probes`): a matmul and
   an exact (``topk`` or binned) or approximate reduction, or the routed
   two-level selection (``ops.routed_coarse.routed_select_ext``), whose
   per-probe list sizes and offsets feed the schedule directly;
2. LUTs with the -2 factor folded in (``build_luts_ext`` semantics), the
   norm table kept separate;
3. the ``max_codes`` slot schedule (:func:`probe_schedule`, counterpart of
   ``_probe_schedule_fields``) at ``gran`` = 256 (chunk) or 1024 (quad);
4. the scan, :func:`adc_scan_slots` — the kernel on CUDA tensors, its plain
   version :func:`adc_scan_slots_plain` on CPU tensors;
5. bin-32 top-k;
6. id resolution.

With ``two_phase=True`` (the JAX ``scan_topk="twophase"`` engine,
``adc_search_tiles_2p`` / ``adc_search_quad_2p``) steps 4-5 become
:func:`two_phase_topk`: per-slot minima from the min-scan kernel
(:func:`adc_scan_slots_min`), an exact top-k over them, a rescan of the
chosen slots with the wide kernel, and an exact top-k over their lanes.

Only the scans are kernels; the rest is plain torch, as the JAX package
left it to XLA. The TPU tile formats (24/72-row tiles, pad rows, list
alignment) are gone: the kernel reads the store's flat ``codes [N, M]``
and ``norm_codes [N]`` in place, and a slot is a (start row, length, bias)
triple.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivfhnsw_tpu_torch.ops.cuda.build import check_arg as _check
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget
from ivfhnsw_tpu_torch.ops.pq import _pq_ip_luts
from ivfhnsw_tpu_torch.ops.routed_coarse import routed_select_ext
from ivfhnsw_tpu_torch.ops.topk import (binned_topk_smallest,
                                       topk_smallest)

CHUNK = 256    # slot width of the JAX package's "chunk" layout
RCHUNK = 1024  # slot width of its "quad" layout
KSUB = 256


def build_luts(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """[B, d] queries -> [B, M, 256] f32 scan tables holding
    -2 * <q_m, codebook_m[k]> (term3 with its factor folded, as rows 0..M-1
    of ``build_luts_ext``). The norm table stays a separate [256] input."""
    return (-2.0 * _pq_ip_luts(queries, codebooks)).contiguous()


def probe_schedule(probes: torch.Tensor, qc_dists: torch.Tensor,
                   centroid_norms: torch.Tensor, list_offsets: torch.Tensor,
                   max_codes: int, nslots: int, gran: int):
    """Expand each query's probes (ascending coarse distance) into ``nslots``
    slots of ``gran`` codes. Integer ops only.

    A probe's list is included iff ``max_codes <= 0`` or the codes of the
    probes before it number fewer than ``max_codes`` (the reference's
    stop-after-the-crossing-list rule); an included list of n codes takes
    ceil(n / gran) consecutive slots. Slots beyond ``nslots`` drop the
    farthest probes' tails.

    Returns (start [B, nslots] int64 — first code row of the slot,
             len [B, nslots] int32 — codes in the slot (<= gran; 0 = empty),
             bias [B, nslots] f32 — term1 = qc_dist - ||c||^2 of its probe)."""
    off = list_offsets.long()
    p = probes.long()
    lo = off[p]
    sizes = off[p + 1] - lo                                   # [B, P]
    start, ln, bias, _ = slot_schedule(lo, sizes,
                                       probe_budget(sizes, max_codes),
                                       qc_dists - centroid_norms[p], nslots,
                                       gran)
    return start, ln, bias


def slot_schedule(lo: torch.Tensor, sizes: torch.Tensor,
                  included: torch.Tensor, term1: torch.Tensor, nslots: int,
                  gran: int):
    """Lay the windows of each query's included probes, in probe order,
    into ``nslots`` slots of ``gran`` codes: probe p's window (rows
    [lo, lo + sizes) of the flat store) takes ceil(sizes / gran)
    consecutive slots when included[p]. lo, sizes [B, P] int64; included
    [B, P] bool; term1 [B, P] f32.

    Returns (start [B, nslots] int64, len [B, nslots] int32 (0 = empty),
    bias [B, nslots] f32 = term1 of the slot's probe, seg [B, nslots] int32
    = the slot's probe index); every field is 0 in an empty slot."""
    B, P = sizes.shape
    tcnt = torch.where(included, (sizes + gran - 1) // gran, 0)
    bounds = torch.cumsum(tcnt, dim=1)
    first = bounds - tcnt                                     # first slot
    j = torch.arange(nslots, device=sizes.device).expand(B, nslots)
    pi = torch.searchsorted(bounds, j.contiguous(), right=True)
    pi = pi.clamp_max(P - 1)
    valid = j < bounds[:, -1:]
    within = j - torch.gather(first, 1, pi)
    start = torch.gather(lo, 1, pi) + within * gran
    ln = (torch.gather(sizes, 1, pi) - within * gran).clamp(0, gran)
    bias = torch.gather(term1, 1, pi)
    return (torch.where(valid, start, 0),
            torch.where(valid, ln, 0).to(torch.int32),
            torch.where(valid, bias, 0.0),
            torch.where(valid, pi, 0).to(torch.int32))


def adc_scan_slots_plain(lut: torch.Tensor, norm_tab: torch.Tensor,
                         codes: torch.Tensor, norm_codes: torch.Tensor,
                         start: torch.Tensor, length: torch.Tensor,
                         bias: torch.Tensor, gran: int,
                         rotate: bool = False) -> torch.Tensor:
    """Plain-torch version of the scan kernel (same function, same
    summation order: bias, norm, then m = 0..M-1).

    out[b, s*gran + l] = bias[b,s] + norm_tab[norm_codes[r]]
                         + sum_m lut[b, m, codes[r, m]],  r = start[b,s] + l,
    for l < len[b,s], and +inf elsewhere. Returns [B, nslots*gran] f32.

    With ``rotate`` lane l adds its rows in the order (t + l) mod M for
    t = 0..M-1 instead: the order of the scan lab's bank-skewed kernels
    (``ops/cuda/scan_lab.py::lane_row``), the same sum up to f32 rounding."""
    B, S = start.shape
    M = codes.shape[1]
    lane = torch.arange(gran, device=start.device)
    valid = lane < length.long()[:, :, None]                  # [B, S, gran]
    if codes.shape[0] == 0:
        return torch.full((B, S * gran), float("inf"), device=start.device)
    row = torch.where(valid, start[:, :, None] + lane, 0).reshape(B, S * gran)
    shift = lane.repeat(S) if rotate else 0                   # [S*gran] or 0
    flat_lut, flat_codes, row_m = (lut.reshape(B, M * KSUB),
                                   codes.reshape(-1), row * M)
    acc = bias.repeat_interleave(gran, dim=1) + norm_tab[norm_codes[row].long()]
    for t in range(M):
        m = (shift + t) % M
        acc = acc + torch.gather(flat_lut, 1,
                                 m * KSUB + flat_codes[row_m + m].long())
    return torch.where(valid.reshape(B, S * gran), acc, float("inf"))


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``name`` of ``csrc/adc_scan.cu`` (built at first
    use): 8 pointers, B, nslots, M, gran, the stream; returns a CUDA error
    code."""
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = getattr(load_library("adc_scan"), name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scan(wrapper, plain, out_cols: int, lut: torch.Tensor,
          norm_tab: torch.Tensor, codes: torch.Tensor,
          norm_codes: torch.Tensor, start: torch.Tensor,
          length: torch.Tensor, bias: torch.Tensor,
          gran: int) -> torch.Tensor:
    """Check the arguments of scan wrapper ``wrapper``, then run ``plain``
    on CPU tensors, or on CUDA tensors launch the entry point ``ivf_`` +
    its name into a new [B, out_cols] f32 output (raising if the launch
    fails) and count the launch in ``wrapper.launches``."""
    fn = wrapper.__name__
    B, S = start.shape
    N, M = codes.shape
    dev = lut.device
    _check("lut", lut, torch.float32, (B, M, KSUB), dev, fn)
    _check("norm_tab", norm_tab, torch.float32, (KSUB,), dev, fn)
    _check("codes", codes, torch.uint8, (N, M), dev, fn)
    _check("norm_codes", norm_codes, torch.uint8, (N,), dev, fn)
    _check("start", start, torch.int64, (B, S), dev, fn)
    _check("length", length, torch.int32, (B, S), dev, fn)
    _check("bias", bias, torch.float32, (B, S), dev, fn)
    if gran <= 0 or max(B, S, M, gran) >= 2 ** 31:
        raise ValueError(f"{fn}: unsupported sizes B={B} S={S} M={M} "
                         f"gran={gran}")
    args = (lut, norm_tab, codes, norm_codes, start, length, bias)
    if dev.type == "cpu":
        return plain(*args, gran)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    out = torch.empty((B, out_cols), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry(f"ivf_{fn}")(*(t.data_ptr() for t in args),
                                 out.data_ptr(), B, S, M, gran, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    wrapper.launches += 1
    return out


def adc_scan_slots(lut: torch.Tensor, norm_tab: torch.Tensor,
                   codes: torch.Tensor, norm_codes: torch.Tensor,
                   start: torch.Tensor, length: torch.Tensor,
                   bias: torch.Tensor, gran: int) -> torch.Tensor:
    """The scan: [B, nslots*gran] f32 distances (see
    :func:`adc_scan_slots_plain` for the function).

    lut [B, M, 256] f32; norm_tab [256] f32; codes [N, M] u8; norm_codes
    [N] u8; start [B, S] int64; length [B, S] int32; bias [B, S] f32.
    Requires start + length <= N wherever length > 0.

    CPU tensors go to the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. ``launches`` counts
    kernel launches."""
    return _scan(adc_scan_slots, adc_scan_slots_plain, start.shape[1] * gran,
                 lut, norm_tab, codes, norm_codes, start, length, bias, gran)


adc_scan_slots.launches = 0


def adc_scan_slots_min_plain(lut: torch.Tensor, norm_tab: torch.Tensor,
                             codes: torch.Tensor, norm_codes: torch.Tensor,
                             start: torch.Tensor, length: torch.Tensor,
                             bias: torch.Tensor, gran: int,
                             rotate: bool = False) -> torch.Tensor:
    """Plain-torch version of the min-scan kernel: the wide scan's per-slot
    minimum, mins[b, s] = min_l out[b, s*gran + l] (+inf for an empty
    slot), ``rotate`` as in :func:`adc_scan_slots_plain`. Returns
    [B, nslots] f32."""
    B, S = start.shape
    out = adc_scan_slots_plain(lut, norm_tab, codes, norm_codes, start,
                               length, bias, gran, rotate)
    return out.view(B, S, gran).amin(dim=-1)


def adc_scan_slots_min(lut: torch.Tensor, norm_tab: torch.Tensor,
                       codes: torch.Tensor, norm_codes: torch.Tensor,
                       start: torch.Tensor, length: torch.Tensor,
                       bias: torch.Tensor, gran: int) -> torch.Tensor:
    """Phase 1 of the two-phase top-k: [B, nslots] f32 per-slot minima of
    the scan (see :func:`adc_scan_slots_min_plain`), bias included, so
    they equal ``adc_scan_slots(...).view(B, S, gran).amin(-1)`` bit for
    bit. Arguments and requirements as :func:`adc_scan_slots`.

    CPU tensors go to the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. ``launches`` counts
    kernel launches."""
    return _scan(adc_scan_slots_min, adc_scan_slots_min_plain,
                 start.shape[1], lut, norm_tab, codes, norm_codes, start,
                 length, bias, gran)


adc_scan_slots_min.launches = 0


def search_core(queries: torch.Tensor, centroids: torch.Tensor,
                centroid_norms: torch.Tensor, codebooks: torch.Tensor,
                norm_centroids: torch.Tensor, codes: torch.Tensor,
                ids: torch.Tensor, norm_codes: torch.Tensor,
                list_offsets: torch.Tensor, max_codes: int, *, nprobe: int,
                k: int, nslots: int, gran: int, coarse_block: int,
                lut_queries: torch.Tensor | None = None,
                two_phase: bool = False, **coarse):
    """End-to-end IVFADC search of a query batch on the fused engine.
    ``lut_queries`` (the OPQ-rotated queries) replaces ``queries`` for the
    LUTs; coarse selection stays in the original space. ``two_phase``
    selects :func:`two_phase_topk` in place of the wide scan + bin-32
    top-k (same results: distances exact, labels may differ at ties).
    ``coarse`` holds :func:`select_probes`' keywords. Returns (dists
    [B, k] f32 ascending, labels [B, k] int64, -1 where the distance is
    +inf)."""
    args = scan_inputs(queries, centroids, centroid_norms, codebooks,
                       norm_centroids, codes, norm_codes, list_offsets,
                       max_codes, nprobe=nprobe, nslots=nslots, gran=gran,
                       coarse_block=coarse_block, lut_queries=lut_queries,
                       **coarse)
    return scan_topk(args, ids, k, gran, two_phase)


def select_probes(queries: torch.Tensor, centroids: torch.Tensor,
                  centroid_norms: torch.Tensor, list_offsets: torch.Tensor, *,
                  nprobe: int, coarse_block: int, exact_reduce: str = "topk",
                  approx: bool = False, recall_target: float = 0.95,
                  routed: tuple | None = None, routed_w: int = 0):
    """Step 1 of :func:`search_core`: each query's ``nprobe`` probes in
    ascending coarse distance, by the streaming sweep
    (``ops.distances.streaming_topk_l2`` with ``exact_reduce``, ``approx``
    and ``recall_target``) or, when ``routed`` = (supers, super_sqn, table)
    is given, by ``routed_select_ext`` over ``routed_w`` supers (the
    counterpart of the JAX ``_probe_schedule_fields`` path: sizes and row
    offsets come with the probes, no per-probe gather). Returns (qc_dists
    f32, probes int64, term1 = qc_dist - ||c||^2 f32, lo int64 = first row
    of the probe's list, sizes int64), all [B, nprobe]."""
    if routed is not None:
        qc_dists, probes, term1, sizes, lo = routed_select_ext(
            queries, *routed, nprobe=nprobe, w=routed_w)
        return qc_dists, probes, term1, lo, sizes
    qc_dists, probes = streaming_topk_l2(
        queries, centroids, nprobe, block=coarse_block,
        point_sqnorms=centroid_norms, exact_reduce=exact_reduce,
        approx=approx, recall_target=recall_target)
    off = list_offsets.long()
    lo = off[probes]
    return (qc_dists, probes, qc_dists - centroid_norms[probes], lo,
            off[probes + 1] - lo)


def scan_inputs(queries: torch.Tensor, centroids: torch.Tensor,
                centroid_norms: torch.Tensor, codebooks: torch.Tensor,
                norm_centroids: torch.Tensor, codes: torch.Tensor,
                norm_codes: torch.Tensor, list_offsets: torch.Tensor,
                max_codes: int, *, nprobe: int, nslots: int, gran: int,
                coarse_block: int, lut_queries: torch.Tensor | None = None,
                **coarse) -> tuple:
    """Steps 1-3 of :func:`search_core` (coarse, schedule, LUTs): the scan
    inputs (lut, norm_tab, codes, norm_codes, start, length, bias) in
    :func:`adc_scan_slots`' order. ``coarse`` holds
    :func:`select_probes`' keywords."""
    _, _, term1, lo, sizes = select_probes(
        queries, centroids, centroid_norms, list_offsets, nprobe=nprobe,
        coarse_block=coarse_block, **coarse)
    start, length, bias, _ = slot_schedule(
        lo, sizes, probe_budget(sizes, max_codes), term1, nslots, gran)
    lut = build_luts(queries if lut_queries is None else lut_queries,
                     codebooks)
    return (lut, norm_centroids, codes, norm_codes, start, length, bias)


def scan_topk(args: tuple, ids: torch.Tensor, k: int, gran: int,
              two_phase: bool = False):
    """Steps 4-6 of :func:`search_core` over :func:`scan_inputs`' ``args``:
    the wide scan + bin-32 top-k, or :func:`two_phase_topk`."""
    if two_phase:
        return two_phase_topk(*args, ids, k, gran)
    return topk_labels(adc_scan_slots(*args, gran), args[4], ids, k, gran)


def topk_labels(dists: torch.Tensor, start: torch.Tensor, ids: torch.Tensor,
                k: int, gran: int):
    """Bin-32 top-k of the scan output [B, nslots*gran] and id resolution
    through the slots' start rows. Returns (dists [B, k] ascending,
    labels [B, k] int64, -1 where the distance is +inf)."""
    best, sel = binned_topk_smallest(dists, k, bin_size=32)
    return best, slot_labels(best, sel, start, ids, gran)


def slot_labels(best: torch.Tensor, sel: torch.Tensor, start: torch.Tensor,
                ids: torch.Tensor, gran: int) -> torch.Tensor:
    """Ids of the scan-output lanes ``sel`` [B, k] (lane s*gran + l is row
    start[b, s] + l of the store); -1 where ``best`` is +inf."""
    finite = torch.isfinite(best)
    pos = torch.gather(start, 1, sel // gran) + sel % gran
    labels = ids[torch.where(finite, pos, 0)].long()
    return torch.where(finite, labels, -1)


def two_phase_topk(lut: torch.Tensor, norm_tab: torch.Tensor,
                   codes: torch.Tensor, norm_codes: torch.Tensor,
                   start: torch.Tensor, length: torch.Tensor,
                   bias: torch.Tensor, ids: torch.Tensor, k: int, gran: int):
    """The exact two-phase top-k over a slot schedule (counterpart of the
    JAX ``adc_search_tiles_2p`` / ``adc_search_quad_2p``):

    1. per-slot minima, :func:`adc_scan_slots_min` [B, S];
    2. the ksel = min(k, S) slots of smallest minimum (exact top-k; slots
       are distinct, so no lane is counted twice);
    3. their (start, len, bias), rescanned lane by lane with
       :func:`adc_scan_slots` [B, ksel*gran];
    4. an exact top-k over those lanes and ids through the chosen slots.

    A slot holding one of the true k nearest has a minimum no larger than
    the k-th distance, and at most k slots can be strictly smaller, so the
    chosen slots hold every true neighbour (equal distances at the k-th
    place may swap labels). The minima carry the bias in the rescan's own
    arithmetic, so the selection sees exactly the distances it returns.
    A query with fewer than k non-empty slots chooses empty ones (minimum
    +inf); their lanes are +inf and get label -1, and the rescan width
    ksel*gran >= k whenever gran >= k, else the top-k pads with +inf.
    Returns (dists [B, k] ascending, labels [B, k] int64)."""
    mins = adc_scan_slots_min(lut, norm_tab, codes, norm_codes, start,
                              length, bias, gran)
    _, ssel = topk_smallest(mins, min(k, mins.shape[1]))
    st, ln, bs = (torch.gather(x, 1, ssel) for x in (start, length, bias))
    dists = adc_scan_slots(lut, norm_tab, codes, norm_codes, st, ln, bs, gran)
    best, sel = topk_smallest(dists, k)
    return best, slot_labels(best, sel, st, ids, gran)
