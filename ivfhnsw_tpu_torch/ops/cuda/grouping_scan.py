"""Fused Grouping(+Pruning) search engine (``engine="fused"`` of
``IVFADCGroupingIndex``) around the hand-written grouping scan kernel
``csrc/grouping_scan.cu``.

Counterpart of ``ivfhnsw_tpu/ops/pallas/grouping_scan.py::
grouping_pallas_search_core`` (exact coarse only), as :func:`scan_inputs`
(steps 1-4) then :func:`scan_topk` (steps 5-6). The steps:

1. exact coarse top-``nprobe``;
2. neighbour distances, the pruning threshold, term1 [B, P] and the term2
   table [B, P, nsubc] with +inf on pruned and empty subgroups
   (``ops.grouping.query_terms``);
3. the slot schedule (:func:`grouping_schedule`, counterpart of
   ``_grouping_schedule``) at ``gran`` = 256 or 1024 codes;
4. LUTs from the (OPQ-rotated) queries;
5. the scan, :func:`grouping_scan_slots` — the kernel on CUDA tensors, its
   plain version :func:`grouping_scan_slots_plain` on CPU tensors — with
   each 32-lane bin's minimum;
6. bin-32 top-k over those minima and id resolution.

Only step 5 is a kernel; the rest is plain torch, as the JAX package left it
to XLA. The TPU's group-aligned tiles (subcentroid ids in tile row 17 or
rows 68-71) are gone: the kernel reads the store's flat ``codes``,
``norm_codes`` and per-code subcentroid bytes (``GroupedView.subc_t``) in
place, and a slot is a (start row, length, term1, probe) record.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivfhnsw_tpu_torch.ops.cuda.adc_scan import (KSUB, _check, bin_minima,
                                                 build_luts, slot_schedule,
                                                 topk_labels)
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget, query_terms
from ivfhnsw_tpu_torch.utils.profiling import span

# Shared memory a block of the kernel may use on sm_90 (227 KB).
MAX_SMEM = 232448


def grouping_schedule(probes: torch.Tensor, term1: torch.Tensor,
                      eff_sizes: torch.Tensor, group_sizes: torch.Tensor,
                      group_offsets: torch.Tensor, max_codes: int,
                      nslots: int, gran: int):
    """Slots at group granularity: an included probe's whole group window
    (``group_sizes``, pruned subgroups too) takes ceil(size / gran)
    slots; the max_codes budget counts the unpruned ``eff_sizes`` of the
    probes before it, and a group with nothing left after pruning gets no
    slot (its lanes could only be +inf). probes, term1, eff_sizes,
    group_sizes [B, P]; group_offsets [nc + 1] int64.

    Returns (start [B, nslots] int64, len [B, nslots] int32,
             bias [B, nslots] f32 = term1, seg [B, nslots] int32 = probe
             index); see ``adc_scan.slot_schedule``."""
    included = probe_budget(eff_sizes, max_codes) & (eff_sizes > 0)
    return slot_schedule(group_offsets[probes.long()], group_sizes,
                         included, term1, nslots, gran)


def grouping_scan_slots_plain(lut: torch.Tensor, norm_tab: torch.Tensor,
                              t2: torch.Tensor, codes: torch.Tensor,
                              norm_codes: torch.Tensor, subc: torch.Tensor,
                              start: torch.Tensor, length: torch.Tensor,
                              bias: torch.Tensor, seg: torch.Tensor,
                              gran: int) -> torch.Tensor:
    """Plain-torch version of the grouping scan kernel (same function, same
    summation order: bias, norm, term2, then m = 0..M-1).

    out[b, s*gran + l] = bias[b,s] + norm_tab[norm_codes[r]]
                         + t2[b, seg[b,s], subc[r]]
                         + sum_m lut[b, m, codes[r, m]],   r = start[b,s] + l,
    for l < len[b,s], and +inf elsewhere; a +inf term2 (pruned subgroup)
    gives +inf. Returns [B, nslots*gran] f32."""
    B, S = start.shape
    P, nsub = t2.shape[1:]
    lane = torch.arange(gran, device=start.device)
    valid = lane < length.long()[:, :, None]                  # [B, S, gran]
    if codes.shape[0] == 0:
        return torch.full((B, S * gran), float("inf"), device=start.device)
    row = torch.where(valid, start[:, :, None] + lane, 0)     # [B, S, gran]
    t2_idx = (seg.long()[:, :, None] * nsub + subc[row].long()).reshape(
        B, S * gran)
    row = row.reshape(B, S * gran)
    acc = bias.repeat_interleave(gran, dim=1) + norm_tab[norm_codes[row].long()]
    acc = acc + torch.gather(t2.reshape(B, P * nsub), 1, t2_idx)
    for m in range(codes.shape[1]):
        acc = acc + torch.gather(lut[:, m, :], 1, codes[row, m].long())
    return torch.where(valid.reshape(B, S * gran), acc, float("inf"))


@functools.lru_cache(maxsize=None)
def _kernel():
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = load_library("grouping_scan").ivf_grouping_scan_slots
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(M: int, P: int, nsubc: int) -> int:
    """Dynamic shared memory of one kernel block: the query's LUT and the
    norm table ((M+1) x 256 f32) and its term2 table (P x nsubc f32)."""
    return ((M + 1) * KSUB + P * nsubc) * 4


def check_scan_args(fn: str, lut: torch.Tensor, norm_tab: torch.Tensor,
                    t2: torch.Tensor, codes: torch.Tensor,
                    norm_codes: torch.Tensor, subc: torch.Tensor,
                    start: torch.Tensor, length: torch.Tensor,
                    bias: torch.Tensor, seg: torch.Tensor, gran: int,
                    extra_smem: int = 0) -> tuple:
    """Raise unless the arguments are what a grouping scan kernel takes
    (device, dtype, shape, contiguity, sizes below 2^31, the tables plus
    ``extra_smem`` bytes within a block's shared memory), for wrapper
    ``fn``. Returns (B, S, M, P, nsubc)."""
    B, S = start.shape
    N, M = codes.shape
    P, nsubc = t2.shape[1:]
    dev = lut.device
    _check("lut", lut, torch.float32, (B, M, KSUB), dev, fn)
    _check("norm_tab", norm_tab, torch.float32, (KSUB,), dev, fn)
    _check("t2", t2, torch.float32, (B, P, nsubc), dev, fn)
    _check("codes", codes, torch.uint8, (N, M), dev, fn)
    _check("norm_codes", norm_codes, torch.uint8, (N,), dev, fn)
    _check("subc", subc, torch.uint8, (N,), dev, fn)
    _check("start", start, torch.int64, (B, S), dev, fn)
    _check("length", length, torch.int32, (B, S), dev, fn)
    _check("bias", bias, torch.float32, (B, S), dev, fn)
    _check("seg", seg, torch.int32, (B, S), dev, fn)
    if gran <= 0 or max(B, S * gran, M, P * nsubc) >= 2 ** 31:
        raise ValueError(f"{fn}: unsupported sizes B={B} S={S} M={M} "
                         f"gran={gran} P={P} nsubc={nsubc}")
    need = smem_bytes(M, P, nsubc) + extra_smem
    if need > MAX_SMEM:
        raise ValueError(f"{fn}: LUT + term2 table need {need} B of shared "
                         f"memory, above the {MAX_SMEM} B a block may use")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {dev}")
    return B, S, M, P, nsubc


def launch_scan(fn: str, entry, args: tuple, outs: tuple, dims: tuple,
                gran: int, *tail: int) -> None:
    """Launch C entry point ``entry`` (the ten scan tensors ``args``, the
    output tensors ``outs`` with None passed as null, B, S, M, gran, P,
    nsubc, ``tail``, the stream) on the current stream of the tensors'
    CUDA device; raises if the launch fails."""
    B, S, M, P, nsubc = dims
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*(t.data_ptr() for t in args),
                   *(None if t is None else t.data_ptr() for t in outs),
                   B, S, M, gran, P, nsubc, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")


def grouping_scan_slots(lut: torch.Tensor, norm_tab: torch.Tensor,
                        t2: torch.Tensor, codes: torch.Tensor,
                        norm_codes: torch.Tensor, subc: torch.Tensor,
                        start: torch.Tensor, length: torch.Tensor,
                        bias: torch.Tensor, seg: torch.Tensor,
                        gran: int, bins: bool = False):
    """The grouping scan: [B, nslots*gran] f32 distances (see
    :func:`grouping_scan_slots_plain` for the function). With ``bins``
    (gran % 32 == 0) returns (distances, their ``adc_scan.bin_minima``
    [B, nslots*gran/32]), the kernel writing both in one pass.

    lut [B, M, 256] f32; norm_tab [256] f32; t2 [B, P, nsubc] f32; codes
    [N, M] u8; norm_codes, subc [N] u8; start [B, S] int64; length, seg
    [B, S] int32; bias [B, S] f32. Requires start + length <= N, seg < P
    and subc < nsubc wherever length > 0.

    CPU tensors go to the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. ``launches`` counts
    kernel launches."""
    fn = "grouping_scan_slots"
    args = (lut, norm_tab, t2, codes, norm_codes, subc, start, length, bias,
            seg)
    with span("ivf.scan"):
        dims = check_scan_args(fn, *args, gran)
        if bins and gran % 32:
            raise ValueError(f"{fn}: bin minima need gran % 32 == 0, got "
                             f"gran={gran}")
        if lut.device.type == "cpu":
            out = grouping_scan_slots_plain(*args, gran)
            return (out, bin_minima(out)) if bins else out
        B, S = dims[:2]
        out = torch.empty((B, S * gran), dtype=torch.float32,
                          device=lut.device)
        bmin = (torch.empty((B, S * gran // 32), dtype=torch.float32,
                            device=lut.device) if bins else None)
        launch_scan(fn, _kernel(), args, (out, bmin), dims, gran)
    grouping_scan_slots.launches += 1
    return (out, bmin) if bins else out


grouping_scan_slots.launches = 0


def scan_inputs(queries: torch.Tensor, centroids: torch.Tensor,
                centroid_norms: torch.Tensor, codebooks: torch.Tensor,
                norm_centroids: torch.Tensor, codes: torch.Tensor,
                norm_codes: torch.Tensor, subc: torch.Tensor,
                group_offsets: torch.Tensor, sub_sizes: torch.Tensor,
                nn_idxs: torch.Tensor, alphas: torch.Tensor,
                inter_dists: torch.Tensor, max_codes: int, *, nprobe: int,
                nslots: int, gran: int, coarse_block: int, do_pruning: bool,
                exact_reduce: str = "topk", approx: bool = False,
                recall_target: float = 0.95,
                lut_queries: torch.Tensor | None = None) -> tuple:
    """Steps 1-4 of the fused Grouping(+Pruning) search of a query batch
    (coarse, grouping terms, schedule, LUTs). Returns (the scan inputs
    (lut, norm_tab, t2, codes, norm_codes, subc, start, length, bias, seg)
    in :func:`grouping_scan_slots`' order, eff_sizes [B, nprobe] the rows
    of each probe's unpruned subgroups). ``lut_queries`` (the OPQ-rotated
    queries) replaces ``queries`` for the LUTs; coarse selection and the
    grouping terms stay in the original space."""
    with span("ivf.coarse"):
        qc_dists, probes = streaming_topk_l2(
            queries, centroids, nprobe, block=coarse_block,
            point_sqnorms=centroid_norms, exact_reduce=exact_reduce,
            approx=approx, recall_target=recall_target)
    with span("ivf.tables"):
        term1, term2, scan, ssz = query_terms(
            queries, qc_dists, probes, centroids, centroid_norms, nn_idxs,
            alphas, inter_dists, sub_sizes, max_codes, do_pruning)
        t2 = torch.where(scan, term2, float("inf"))
        eff_sizes = torch.where(scan, ssz, 0).sum(dim=2)
        start, length, bias, seg = grouping_schedule(
            probes, term1, eff_sizes, ssz.sum(dim=2), group_offsets,
            max_codes, nslots, gran)
        lut = build_luts(queries if lut_queries is None else lut_queries,
                         codebooks)
    return ((lut, norm_centroids, t2, codes, norm_codes, subc, start, length,
             bias, seg), eff_sizes)


def scan_topk(args: tuple, ids: torch.Tensor, k: int, gran: int):
    """Steps 5-6 over :func:`scan_inputs`' scan inputs ``args``: the scan
    with its bin minima, the bin-32 top-k over them (gran % 32 == 0) and id
    resolution. Returns (dists [B, k] f32 ascending, labels [B, k] int64,
    -1 where the distance is +inf)."""
    dists, bmin = grouping_scan_slots(*args, gran, bins=True)
    return topk_labels(dists, args[6], ids, k, gran, bmin)
