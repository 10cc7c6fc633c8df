"""The scan lab: every variant of ``ops/cuda/scan_lab.py`` on the fused
engine's own schedule for one query batch, each checked and timed.
Counterpart of ``tools/kernel_lab.py``'s ``main()`` (:811-998), which asks
the same questions of the TPU kernels.

Run from the root of a checkout:

    python -m ivfhnsw_tpu_torch.tools.kernel_lab -cache DIR [-device cuda]
        [-batch 8192] [-nprobe 32] [-max_codes 10000]

DIR holds ``centroids.npy``, ``bench.pq``, ``bench.norm_pq``,
``bench.index`` and ``queries.npy``, the JAX lab's cache names, so a cache
written by the JAX ``bench.py`` reads as well as one written by
:func:`write_cache`. d and nc come from the ``.index`` header, M from the
``.pq``. ``-device`` defaults to cuda and raises without a card; ``-device
cpu`` runs the plain versions (host times).

For each slot width (256 and 1024) the lab takes the batch's scan inputs
from ``IVFADCIndex.scan_inputs``, as the fused engine builds them (coarse
top-nprobe, ``probe_schedule``, LUTs), then for each variant:
one launch, its output against its plain version with ``torch.equal`` and,
for a full-function variant, against ``adc_scan_slots`` /
``adc_scan_slots_min``, with ``torch.equal`` too, except the skew variants
(they add a lane's LUT rows in a rotated order: rtol 1e-4 / atol 1e-3); its
time (median of CUDA events after warm-up), its plain
version's time, its bound and conflict-free lookup time, and its blocks per
SM. The reference
variants with one LUT copy are also timed with the shared memory of their
8-copy counterparts, so that the copies compare at equal occupancy. One
line per record; :func:`run` returns the records and raises after the last
line if any variant disagreed.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex, read_index_header
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.ops.cuda.adc_scan import (CHUNK, RCHUNK, adc_scan_slots,
                                                 adc_scan_slots_min)
from ivfhnsw_tpu_torch.ops.pq import ProductQuantizer
from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams
from ivfhnsw_tpu_torch.utils.roofline import (bound, lookup_ms, rows_touched,
                                               scan_bound)
from ivfhnsw_tpu_torch.utils.timer import device_ms, host_ms

RTOL, ATOL = 1e-4, 1e-3   # a skew variant against the production kernel;
                          # compute-only / copy-only against their plain
                          # versions
# Each one-copy reference variant, timed again at its 8-copy twin's shared
# memory (so at its occupancy).
EQUAL_OCCUPANCY = {"pipe256_c1_d8_s2": "pipe256_c8_d8_s2",
                   "pipe256_c1_d8_s2_min": "pipe256_c8_d8_s2_min",
                   "pipe1024_c1_d2_s1": "pipe1024_c8_d2_s1",
                   "pipe1024_c1_d2_s1_min": "pipe1024_c8_d2_s1_min"}
# The decomposition of each slot width and epilogue: reference (full),
# compute only, copy only, 8 LUT copies.
DECOMPOSITION = {
    (CHUNK, "wide"): ("pipe256_c1_d8_s2", "comp256_wide", "copy256_wide",
                      "pipe256_c8_d8_s2"),
    (CHUNK, "min"): ("pipe256_c1_d8_s2_min", "comp256_min", "copy256_min",
                     "pipe256_c8_d8_s2_min"),
    (RCHUNK, "wide"): ("pipe1024_c1_d2_s1", "comp1024_wide", "copy1024_wide",
                       "pipe1024_c8_d2_s1"),
    (RCHUNK, "min"): ("pipe1024_c1_d2_s1_min", "comp1024_min", "copy1024_min",
                      "pipe1024_c8_d2_s1_min"),
}


def write_cache(index: IVFADCIndex, queries: np.ndarray, cache: str) -> None:
    """Write ``index`` and ``queries`` as a lab cache: ``save_quantizers``,
    ``write`` and ``np.save`` of the centroids and queries."""
    os.makedirs(cache, exist_ok=True)
    np.save(os.path.join(cache, "centroids.npy"),
            index.centroids.cpu().numpy())
    index.save_quantizers(os.path.join(cache, "bench.pq"),
                          os.path.join(cache, "bench.norm_pq"))
    index.write(os.path.join(cache, "bench.index"))
    np.save(os.path.join(cache, "queries.npy"),
            np.asarray(queries, np.float32))


def load_cache(cache: str, device) -> tuple[IVFADCIndex, np.ndarray]:
    """The index and queries of a lab cache, the index on ``device``."""
    d, nc = read_index_header(os.path.join(cache, "bench.index"))
    path_pq = os.path.join(cache, "bench.pq")
    M = ProductQuantizer.load(path_pq, "cpu").M
    index = IVFADCIndex(IndexConfig(d=d, nc=nc, code_size=M), device)
    index.set_centroids(np.load(os.path.join(cache, "centroids.npy")))
    index.load_quantizers(path_pq, os.path.join(cache, "bench.norm_pq"))
    index.read(os.path.join(cache, "bench.index"))
    return index, np.load(os.path.join(cache, "queries.npy"))


def variant_bound(v: sl.Variant, args: tuple, out_numel: int) -> dict:
    """bound() of variant ``v`` on ``args``: what its function must read
    and write once, and its f32 operations (M+1 per valid lane, one more
    for the minimum); and ``lookup_ms``, its M+1 table lookups per valid
    lane at the conflict-free shared-memory rate (copy-only does none). Of
    the schedule, compute-only reads only len (4 B
    per slot) and copy-only start and len (12 B), the full variants also
    bias (16 B)."""
    lut, ntab, codes, _, start, length, _ = args
    M = codes.shape[1]
    valid = int(length.sum())
    ops = valid * (M + 1 + (v.epilogue == "min"))
    if v.kind == "compute_only":   # LUTs, one staged tile, len, output
        return {**bound(lut.numel() * 4 + ntab.numel() * 4
                        + start.numel() * 4 + v.gran * (M + 1)
                        + out_numel * 4, ops),
                "lookup_ms": lookup_ms(valid * (M + 1), lut.device)}
    if v.kind == "copy_only":      # start, len, the touched rows, output
        return {**bound(start.numel() * 12
                        + rows_touched(start, length, codes.shape[0])
                        * (M + 1) + out_numel * 4, ops),
                "lookup_ms": lookup_ms(0, lut.device)}
    return scan_bound(args, out_numel, M + 1, M + 1 + (v.epilogue == "min"))


def _close(out: torch.Tensor, ref: torch.Tensor) -> bool:
    """Same +inf pattern and finite lanes within RTOL / ATOL."""
    fin = torch.isfinite(ref)
    return bool(torch.equal(torch.isinf(out), torch.isinf(ref))
                and torch.allclose(out[fin], ref[fin], rtol=RTOL, atol=ATOL))


def _max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |out - ref| over finite lanes; +inf where the +inf patterns
    differ."""
    if not torch.equal(torch.isinf(out), torch.isinf(ref)):
        return float("inf")
    fin = torch.isfinite(ref)
    return float((out[fin] - ref[fin]).abs().max()) if fin.any() else 0.0


def run(index: IVFADCIndex, queries: np.ndarray, params: SearchParams,
        device, batch: int = 8192, reps: int = 20, log=print) -> list:
    """Every lab variant on the schedule of ``queries[:batch]`` at both slot
    widths; returns one record per variant (and per equal-occupancy
    re-timing). Raises after the last line if a variant differed from its
    plain version or, for a full-function variant, from the production
    kernel (a skew variant: left its tolerance)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    timer = device_ms if on_card else host_ms
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    q = torch.tensor(np.asarray(queries[:batch], np.float32), device=device)
    M = index.store.code_m
    records, bad = [], []
    for gran in (CHUNK, RCHUNK):
        args = index.scan_inputs(q, params, gran)
        B, S = args[4].shape
        chunks = float(((args[5].long() + CHUNK - 1) // CHUNK).sum()) / B
        production = {"wide": adc_scan_slots(*args, gran, bins=True)[0],
                      "min": adc_scan_slots_min(*args, gran)}
        plain_runs = {}
        smem = {}
        variants = [v for v in sl.VARIANTS.values() if v.gran == gran]
        retimes = [(sl.VARIANTS[c1], sl.VARIANTS[c8])
                   for c1, c8 in EQUAL_OCCUPANCY.items()
                   if sl.VARIANTS[c1].gran == gran and on_card]
        for v, floor_of in [(v, None) for v in variants] + retimes:
            wrapper, plain = sl.FUNCTIONS[v.kind]
            floor = smem[floor_of.name] if floor_of is not None else 0
            kw = {"smem_floor": floor} if floor else {}
            out = wrapper(*args, v, **kw)
            sync()
            key = (plain.__name__, v.epilogue, v.kind == "skew")
            if key not in plain_runs:
                plain_runs[key] = (plain(*args, v), timer(
                    lambda: plain(*args, v), reps=3, warmup=1))
            ref, plain_ms = plain_runs[key]
            equal_plain = torch.equal(out, ref)
            err = _max_err(out, ref)
            if v.full:
                prod = production[v.epilogue]
                like_prod = (_close(out, prod) if v.kind == "skew"
                             else torch.equal(out, prod))
                match = equal_plain and like_prod
            else:
                like_prod = None
                match = err <= ATOL + RTOL * float(
                    ref[torch.isfinite(ref)].abs().max())
            ms = timer(lambda: wrapper(*args, v, **kw), reps=reps)
            blocks, smem_bytes = (sl.occupancy(v, M, floor) if on_card
                                  else (None, None))
            if floor_of is None:
                smem[v.name] = smem_bytes
            rec = {"name": v.name + (f"@smem{floor}" if floor else ""),
                   "variant": v.name, "kind": v.kind, "gran": gran,
                   "epilogue": v.epilogue, "copies": v.copies,
                   "depth": v.depth, "slots_per_step": v.slots_per_step,
                   "batched_wait": v.batched_wait,
                   "branchless": v.branchless, "smem_floor": floor,
                   "replaces": v.replaces, "B": B, "slots": S, "ms": ms,
                   "plain_ms": plain_ms, "us_per_query": 1e3 * ms / B,
                   "ns_per_chunk": 1e6 * ms / B / max(chunks, 1e-9),
                   **variant_bound(v, args, out.numel()),
                   "blocks_per_sm": blocks, "smem_bytes": smem_bytes,
                   "equal_plain": equal_plain,
                   "matches_production": like_prod, "max_abs_err": err,
                   "match": match,
                   "timer": "cuda_events" if on_card else "host"}
            records.append(rec)
            if not match:
                bad.append(rec["name"])
            log(f"[lab] {rec['name']:<34} gran={gran} B={B} slots={S}: "
                f"{ms:.4f} ms ({rec['us_per_query']:.4f} us/q, "
                f"{rec['ns_per_chunk']:.2f} ns/chunk), bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                f"({rec['bound_ms'] / ms:.1%}), lookups "
                + ("n/a" if rec["lookup_ms"] is None
                   else f"{rec['lookup_ms']:.4f} ms")
                + f", plain {plain_ms:.3f} ms, "
                f"{blocks} blocks/SM x {smem_bytes} B smem, equal plain "
                f"{equal_plain} production {like_prod}, max_abs_err "
                f"{err!r}, match {match}" + ("" if on_card else " [host]"))
        del production, plain_runs
    if bad:
        raise AssertionError(f"lab variants disagree: {bad}")
    return records


def decomposition(records: list) -> dict:
    """ms of the full reference, compute-only, copy-only, 8-copy and
    one-copy-at-the-8-copy-occupancy variants, per slot width and
    epilogue."""
    ms = {r["name"]: r["ms"] for r in records}
    out = {}
    for (gran, epi), (full, comp, copy, c8) in DECOMPOSITION.items():
        row = {"full": ms.get(full), "compute_only": ms.get(comp),
               "copy_only": ms.get(copy), "copies8": ms.get(c8)}
        at = [r["ms"] for r in records
              if r["variant"] == full and r["smem_floor"]]
        row["copies1_at_copies8_occupancy"] = at[0] if at else None
        out[f"{gran}_{epi}"] = row
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"cache": None, "device": "cuda", "batch": "8192",
            "nprobe": "32", "max_codes": "10000"}
    while argv:
        flag = argv.pop(0)
        if not flag.startswith("-") or flag[1:] not in opts or not argv:
            raise SystemExit(f"usage: python -m ivfhnsw_tpu_torch.tools."
                             f"kernel_lab -cache DIR [-device cuda] [-batch "
                             f"8192] [-nprobe 32] [-max_codes 10000] (at "
                             f"{flag!r})")
        opts[flag[1:]] = argv.pop(0)
    if opts["cache"] is None:
        raise SystemExit("kernel_lab: -cache DIR is required")
    device = torch.device(opts["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {opts['device']}: no CUDA device is "
                           "available; pass -device cpu to run on the CPU")
    index, queries = load_cache(opts["cache"], device)
    params = SearchParams(k=10, nprobe=int(opts["nprobe"]),
                          max_codes=int(opts["max_codes"]))
    records = run(index, queries, params, device, batch=int(opts["batch"]),
                  reps=20 if device.type == "cuda" else 2)
    print(json.dumps({"lab": decomposition(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
