"""The wide probe: the wide-scan kernel (K1/K2, ``csrc/wide_scan.cuh``)
taken apart and its design steps timed in turns against the kernel as first
ported, on a search's own schedule, with their machine instructions per
warp and code.

Run from the root of a checkout (it builds the primary synthetic index, 2M x
128d, nc=4096, code_size=16, as ``tools/bank_probe.py`` does, or with
``-corpus siftlike`` the same index over ``SiftLikeCorpus(65536, seed=1)``,
and takes one 8192-query batch's schedule at nprobe=32, max_codes=10000):

    python -m ivfhnsw_tpu_torch.tools.wide_probe [-device cuda] [-nb 2000000]
        [-batch 8192] [-corpus primary] [-stores real,free] [-rounds 5]
        [-steps first_port,stores,...]

At each slot width (256 and 1024 codes) and on each store (``real``: the
index's codes; ``free``: ``tools/bank_probe.py``'s store whose lookups never
meet in a bank), every step of ``ops/cuda/scan_lab.py::WIDE_STEPS`` and the
production kernel (``adc_scan_slots``) is first held to ``torch.equal``
with its plain version (a "full" step also with the production kernel),
then timed against ``first_port`` in turns (``tools/min_probe.py``'s
``in_turns``: A B B A, ``rounds`` times, CUDA events, the median of 20
launches each; the medians of each side, and in how many of the
2 * ``rounds`` pairs it was the faster), and on the real store once more on
a schedule of one empty slot a query (the staging of the tables alone).
Beside them, the write floor of the card: one ``fill_`` of a tensor of the
output's shape. On the card it also reads each step's lane loop out of
the built library's SASS (``min_probe.kernel_sass``; production is the
steps ``warp`` at 256 and ``dp4a`` at 1024, ``scan_lab.WIDE_PRODUCTION``). One ``[wprobe]``
line and one record per measurement, then a split line per width; the run
raises after the last line if a kernel differed from its plain version. On
``-device cpu`` every wrapper runs the plain version and the times are the
host's.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.ops.cuda.adc_scan import CHUNK, RCHUNK
from ivfhnsw_tpu_torch.tools.bank_probe import bank_stores
from ivfhnsw_tpu_torch.tools.min_probe import (in_turns, kernel_sass,
                                               max_abs_err, siftlike_index,
                                               wins)
from ivfhnsw_tpu_torch.utils.roofline import scan_bound
from ivfhnsw_tpu_torch.utils.timer import device_ms, host_ms

BASELINE = "first_port"
PRODUCTION = "production"
FILL = "fill_"
# The steps chip_smoke.py times (its phase 6d): the first port's split, its
# stores as production had them, one switch a step to the two production
# settings (``dp4a`` at 1024 codes, ``warp`` below), and ``warp``'s split.
SMOKE_STEPS = tuple(sl.WIDE_STEPS)
# The split line's parts: (step, store) beside the first port.
SPLIT = (("stores", "real"), ("noout", "real"), ("comp", "real"),
         ("loads", "real"), (BASELINE, "free"), ("warp_stores", "real"),
         ("warp_noout", "real"), ("warp_comp", "real"),
         ("warp_loads", "real"), (PRODUCTION, "real"), (PRODUCTION, "free"))


def probe_kernels(steps) -> dict:
    """name -> (fn(args, gran), WideStep or None): the production kernel
    and the given steps."""
    out = {PRODUCTION: (lambda a, g: tk.adc_scan_slots(*a, g), None)}
    for s in steps:
        out[s.name] = (lambda a, g, s=s: sl.scan_wide_step(*a, g, s), s)
    return out


def plain_key(step) -> tuple:
    """Steps whose plain versions are one function share a key."""
    if step is None:
        return ("full",)
    return (step.mode, step.layout) if step.mode == "noout" else (step.mode,)


def run(index, queries: np.ndarray, params, device, batch: int = 8192,
        steps=None, stores=("real", "free"), rounds: int = 5, reps: int = 20,
        sass: bool = True, tag: str = "[wprobe]", log=print) -> list:
    """Every step (``steps``: names of ``WIDE_STEPS``, default all) and the
    production kernel on the schedule of ``queries[:batch]`` at both slot
    widths over ``stores``, and the ``fill_`` floor; one record and one
    line per kernel and store. Raises after the last line if a kernel
    differed from its plain version (or a full step from the production
    kernel)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    timer = device_ms if on_card else host_ms
    names = list(steps or sl.WIDE_STEPS)
    if BASELINE not in names:
        names.insert(0, BASELINE)
    kernels = probe_kernels([sl.WIDE_STEPS[n] for n in names])
    q = torch.tensor(np.asarray(queries[:batch], np.float32), device=device)
    records, bad = [], []
    if sass and on_card:
        # production is two of the steps (scan_lab.WIDE_PRODUCTION)
        counts = kernel_sass(None, sl.WIDE_STEPS)
        for name, st in counts.items():
            records.append({"name": name, "sass": st})
            if st is None:
                log(f"{tag} sass {name}: no lane loop found")
                continue
            hist = ", ".join(f"{k} {v:g}"
                             for k, v in st["opcodes_per_code"].items())
            log(f"{tag} sass {name:<14} {st['per_code']:.1f} instructions "
                f"per warp and code ({st['instructions']} in a loop of "
                f"{st['codes']} codes, {st['lds']} LDS): {hist}")
        if not counts:
            log(f"{tag} sass: cuobjdump not found")
    M = index.store.code_m
    occ = ({n: sl.wide_step_occupancy(s, M) for n, (_, s) in kernels.items()
            if s is not None} if on_card else {})
    for gran in (CHUNK, RCHUNK):
        args = index.scan_inputs(q, params, gran)
        B, S = args[4].shape
        every = bank_stores(args[2], args[3])
        empty = (args[4][:, :1] * 0, args[5][:, :1] * 0, args[6][:, :1] * 0)
        fill = int(args[5].sum()) / (B * S * gran)
        o = torch.empty((B, S * gran), dtype=torch.float32, device=device)
        fill_ms = timer(lambda: o.fill_(float("inf")), reps=reps)
        del o
        records.append({"name": FILL, "gran": gran, "ms": fill_ms,
                        "bytes": B * S * gran * 4,
                        "timer": "cuda_events" if on_card else "host"})
        log(f"{tag} {FILL:<14} gran={gran} [{B}, {S * gran}] f32: "
            f"{fill_ms:.4f} ms ({B * S * gran * 4 / fill_ms / 1e6:.1f} GB/s)"
            + ("" if on_card else " [host]"))
        for store in stores:
            a = (*args[:2], *every[store], *args[4:])
            bnd = scan_bound(a, B * S * gran, M + 1, M + 1)
            prod = tk.adc_scan_slots(*a, gran)
            plains, plain_ms = {}, {}
            fa = kernels[BASELINE][0]
            for name, (fn, st) in kernels.items():
                if st is not None and (st.mode in ("compute", "loads")
                                       and M != 16):
                    log(f"{tag} {name:<14} gran={gran} {store}: not built "
                        f"for this store (M={M})")
                    continue
                key = plain_key(st)
                if key not in plains:
                    pl = (lambda: tk.adc_scan_slots_plain(*a, gran)) if (
                        st is None) else (
                        lambda st=st: sl.wide_step_plain(*a, gran, st))
                    plains[key] = pl()
                    plain_ms[key] = timer(pl, reps=1, warmup=0)
                out = fn(a, gran)
                equal = bool(torch.equal(out, plains[key]))
                err = max_abs_err(out, plains[key])
                if key == ("full",):
                    equal = equal and bool(torch.equal(out, prod))
                del out
                rec = {"name": name, "gran": gran, "store": store, "B": B,
                       "slots": S, "lane_fill": fill, "equal_plain": equal,
                       "max_abs_err": err, "plain_ms": plain_ms[key], **bnd,
                       "mode": "full" if st is None else st.mode,
                       "timer": "cuda_events" if on_card else "host"}
                if name == BASELINE:
                    rec["ms"] = timer(lambda: fa(a, gran), reps=reps)
                    turns = f"{rec['ms']:.4f} ms"
                else:
                    med, base, ta, tb = in_turns(
                        lambda: fn(a, gran), lambda: fa(a, gran), timer,
                        rounds, reps)
                    won = wins(ta, tb)
                    rec.update(ms=med, first_port_ms=base, ms_in_turns=ta,
                               first_port_ms_in_turns=tb,
                               over_first_port=med / base, wins=won,
                               pairs=len(ta))
                    turns = (f"{med:.4f} ms, {BASELINE} {base:.4f} ms in "
                             f"turns: {med / base:.3f}x, faster in {won} of "
                             f"{len(ta)} pairs")
                if store == "real" and key == ("full",):
                    rec["staging_ms"] = timer(
                        lambda: fn((*a[:4], *empty), gran), reps=reps)
                    turns += f"; staging alone {rec['staging_ms']:.4f} ms"
                if name in occ:
                    rec["blocks_per_sm"], rec["smem_bytes"], rec[
                        "registers"] = occ[name]
                    turns += (f"; {occ[name][0]} blocks/SM, "
                              f"{occ[name][2]} registers")
                records.append(rec)
                if not equal:
                    bad.append(f"{name}@{gran}/{store}")
                log(f"{tag} {name:<14} gran={gran} {store} B={B} slots={S} "
                    f"fill {fill:.3f}: {turns}; torch.equal to plain: "
                    f"{equal}" + ("" if on_card else " [host]"))
            del prod, plains
    for line in split_lines(records):
        log(f"{tag} {line}")
    if bad:
        raise AssertionError(f"wide probe: kernels differ from their plain "
                             f"versions: {bad}")
    return records


def split_lines(records: list) -> list:
    """One line per slot width: the first port on the real store, its
    staging alone and the ``fill_`` floor, and what each part of the split
    takes in turns beside it (stores only, no output, lookups only, code
    reads only, the conflict-free store; the same for the warp designs),
    then the production kernel on both stores."""
    out = []
    by = {(r["name"], r["gran"], r.get("store")): r for r in records
          if "ms" in r}
    for gran in (CHUNK, RCHUNK):
        parts = []
        for name, store in SPLIT:
            r = by.get((name, gran, store))
            if r and "over_first_port" in r:
                parts.append(f"{name}/{store} {r['ms']:.4f} "
                             f"({r['over_first_port']:.3f}x)")
            elif r:
                parts.append(f"{name}/{store} {r['ms']:.4f}")
        base = by.get((BASELINE, gran, "real"))
        floor = by.get((FILL, gran, None))
        if base and parts:
            out.append(f"split gran={gran}: {BASELINE}/real "
                       f"{base['ms']:.4f} ms, staging alone "
                       f"{base.get('staging_ms', float('nan')):.4f}, "
                       f"{FILL} floor "
                       f"{floor['ms'] if floor else float('nan'):.4f}; "
                       + ", ".join(parts))
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"device": "cuda", "nb": "2000000", "batch": "8192",
            "corpus": "primary", "stores": "real,free", "rounds": "5",
            "steps": ",".join(sl.WIDE_STEPS)}
    while argv:
        flag = argv.pop(0)
        if not flag.startswith("-") or flag[1:] not in opts or not argv:
            raise SystemExit(__doc__)
        opts[flag[1:]] = argv.pop(0)
    device = torch.device(opts["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {opts['device']}: no CUDA device is "
                           "available; pass -device cpu to run on the CPU")
    if opts["corpus"] not in ("primary", "siftlike"):
        raise SystemExit(__doc__)
    if opts["corpus"] == "primary":
        from ivfhnsw_tpu_torch.tools.bank_probe import primary_index
        index, queries, params = primary_index(device, int(opts["nb"]),
                                               int(opts["batch"]))
    else:
        index, queries, params = siftlike_index(device, int(opts["nb"]),
                                                int(opts["batch"]))
    on_card = device.type == "cuda"
    records = run(index, queries, params, device, batch=int(opts["batch"]),
                  steps=opts["steps"].split(","),
                  stores=tuple(opts["stores"].split(",")),
                  rounds=int(opts["rounds"]), reps=20 if on_card else 1)
    print(json.dumps({"wprobe": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
