"""The min probe: the design steps of the min-scan kernel (K3/K4,
``csrc/min_scan.cuh``) timed in turns against the kernel as first ported,
on a search's own schedule, with their machine instructions per warp and
code.

Run from the root of a checkout (it builds the primary synthetic index, 2M x
128d, nc=4096, code_size=16, as ``tools/bank_probe.py`` does, or with
``-corpus siftlike`` the same index over ``SiftLikeCorpus(65536, seed=1)``,
and takes one 8192-query batch's schedule at nprobe=32, max_codes=10000):

    python -m ivfhnsw_tpu_torch.tools.min_probe [-device cuda] [-nb 2000000]
        [-batch 8192] [-corpus primary] [-stores real,free] [-rounds 6]
        [-steps first_port,prmt,...]

At each slot width (256 and 1024 codes) and on each store (``real``: the
index's codes; ``free``: ``tools/bank_probe.py``'s store whose lookups never
meet in a bank), every step of ``ops/cuda/scan_lab.py::MIN_STEPS`` and the
production kernel (``adc_scan_slots_min``) is first held to ``torch.equal``
with its plain version (a "full" step also with the production kernel),
then timed against ``first_port`` in turns (A B B A, ``rounds`` times, CUDA
events, the median of 20 launches each; the medians of each side, and in
how many of the 2 * ``rounds`` pairs it was the faster), and on
the real store once more on a schedule of one empty slot a query (the
staging of the tables alone). On the card it also reads each kernel's loop
out of the built libraries' SASS (``cuobjdump -sass``): the innermost loop
with the most shared-memory and 16-byte global loads, its instructions over
its codes (17 LDS or one 16-byte code load a code). One ``[mprobe]`` line
and one record per measurement; the run raises after the last line if a
kernel differed from its plain version. On ``-device cpu`` every wrapper
runs the plain version and the times are the host's.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.ops.cuda.adc_scan import CHUNK, RCHUNK
from ivfhnsw_tpu_torch.tools.bank_probe import bank_stores
from ivfhnsw_tpu_torch.utils.roofline import (lookup_ms, lookup_wavefronts,
                                              scan_bound)
from ivfhnsw_tpu_torch.utils.timer import device_ms, host_ms

BASELINE = "first_port"
PRODUCTION = "production"
# The steps chip_smoke.py times (its phase 6c): the first port's split, one
# switch a step, the production setting and its split, and the prefetching
# lead.
SMOKE_STEPS = ("first_port", "comp", "loads", "prmt", "off32", "two",
               "stage16", "tma", "dp4a", "dp4a_tma", "dp4a_tma_b8",
               "comp_new", "loads_new", "dp4a_pf_b6", "dp4a1_tma_b8")
LOOKUPS = 17          # LDS a code at M=16: 16 LUT rows and the norm table

# ---- SASS -------------------------------------------------------------------

_FN = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INS = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*\.L_x_(\d+):")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:[!U]*P\w+\s*,\s*)?"
                  r"(?:0x([0-9a-f]+)|`\(\.L_x_(\d+)\))")


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` (or ``nvdisasm``) output -> {function name:
    [[address, opcode, branch target or None], ...]}; the opcode is the
    mnemonic without its modifiers or predicate (``@P0 LDS.U.128`` ->
    ``LDS``), but a 16-byte global load is ``LDG.128`` and a byte load
    ``LDG.U8``. Branch targets are addresses, from ``BRA 0x...`` or from
    ``.L_x_N`` labels."""
    fns, labels = {}, {}
    cur, name, pending = None, None, []
    for line in text.splitlines():
        m = _FN.match(line)
        if m:
            name = m.group(1)
            cur = fns.setdefault(name, [])
            pending = []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INS.match(line)
        if not m or cur is None:
            continue
        addr, body = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[name, lab] = addr
        pending = []
        words = body.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words:
            continue
        parts = words[0].split(".")
        op = parts[0]
        if op == "LDG" and ("128" in parts or "U8" in parts):
            op = "LDG.128" if "128" in parts else "LDG.U8"
        target = None
        b = _BRA.search(body)
        if b:
            target = int(b.group(1), 16) if b.group(1) else (name, b.group(2))
        cur.append([addr, op, target])
    for ins in fns.values():
        for i in ins:
            if isinstance(i[2], tuple):
                i[2] = labels.get(i[2])
    return fns


def loop_stats(ins: list) -> dict | None:
    """The lane loop of one kernel's SASS ``ins`` (``parse_sass``): the
    innermost loop (a backward branch's range holding no other) that loads
    code rows and norm bytes (``LDG.128`` and ``LDG.U8``: the tables'
    staging loads no bytes, the byte loop of M != 16 no rows), the one with
    the most LDS among them; or, in a kernel with none (the COMPUTE mode),
    the innermost loop with the most LDS and no global load. Returns its
    instruction count (NOPs left out), its codes (its 16-byte code loads,
    or LDS / 17 where it loads no row), instructions per code and an opcode
    histogram per code; None when no loop holds a whole code."""
    loops = []
    for addr, op, target in ins:
        if op == "BRA" and isinstance(target, int) and target <= addr:
            loops.append((target, addr))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    bodies = [[op for a, op, _ in ins if lo <= a <= hi and op != "NOP"]
              for lo, hi in inner]
    rows = [b for b in bodies if "LDG.128" in b and "LDG.U8" in b]
    if rows:
        best = max(rows, key=lambda b: (b.count("LDS"), b.count("LDG.128")))
        codes = best.count("LDG.128")
    else:
        lds = [b for b in bodies
               if "LDS" in b and not any(op.startswith("LDG") for op in b)]
        if not lds:
            return None
        best = max(lds, key=lambda b: b.count("LDS"))
        codes = best.count("LDS") // LOOKUPS
    if codes == 0:
        return None
    hist = collections.Counter(best)
    return {"instructions": len(best), "codes": codes,
            "per_code": len(best) / codes, "lds": hist["LDS"],
            "opcodes_per_code": {k: v / codes
                                 for k, v in sorted(hist.items())}}


def cuobjdump() -> str | None:
    """Path of ``cuobjdump`` ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH),
    or None."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def kernel_sass(production: str | None = "adc_scan_slots_min_kernel",
                steps=None) -> dict:
    """Loop statistics (``loop_stats``) of the production kernel
    ``production`` (in ``csrc/adc_scan.cu``'s library; the min kernel by
    default, none for None) and of every step's kernel
    (``csrc/scan_lab.cu``'s; ``steps``, default ``MIN_STEPS``), by step
    name, from ``cuobjdump -sass`` of the libraries ``ops/cuda/build.py``
    builds; {} where cuobjdump is missing."""
    from ivfhnsw_tpu_torch.ops.cuda.build import build_all
    tool = cuobjdump()
    if tool is None:
        return {}
    adc, lab = build_all(["adc_scan", "scan_lab"])
    out = {}
    for lib, wanted in ((adc, {PRODUCTION: production} if production
                         else {}),
                        (lab, {s.name: s.kernel for s in (
                            steps or sl.MIN_STEPS).values()})):
        text = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        fns = parse_sass(text)
        for name, kernel in wanted.items():
            hits = ([kernel] if kernel in fns
                    else [f for f in fns if kernel in f])
            out[name] = loop_stats(fns[hits[0]]) if hits else None
    return out


# ---- timing -------------------------------------------------------------------

def in_turns(fa, fb, timer, rounds: int = 6, reps: int = 20):
    """fa and fb timed in turns (A B B A, ``rounds`` times); returns the
    median of each side and the two lists of times (entry i of one list
    was timed next to entry i of the other)."""
    t = {0: [], 1: []}
    for k in (0, 1, 1, 0) * rounds:
        t[k].append(timer(fa if k == 0 else fb, reps=reps))
    return statistics.median(t[0]), statistics.median(t[1]), t[0], t[1]


def wins(ta: list, tb: list) -> int:
    """Of ``in_turns``' pairs (A next to B), how many A was faster in."""
    return sum(a < b for a, b in zip(ta, tb))


def probe_kernels(steps) -> dict:
    """name -> (fn(args, gran), plain(args, gran), MinStep or None): the
    production kernel and the given steps."""
    out = {PRODUCTION: (lambda a, g: tk.adc_scan_slots_min(*a, g),
                        lambda a, g: tk.adc_scan_slots_min_plain(*a, g),
                        None)}
    for s in steps:
        out[s.name] = (lambda a, g, s=s: sl.scan_min_step(*a, g, s),
                       lambda a, g, s=s: sl.min_step_plain(*a, g, s), s)
    return out


def run(index, queries: np.ndarray, params, device, batch: int = 8192,
        steps=None, stores=("real", "free"), rounds: int = 6, reps: int = 20,
        sass: bool = True, tag: str = "[mprobe]", log=print) -> list:
    """Every step (``steps``: names of ``MIN_STEPS``, default all) and the
    production kernel on the schedule of ``queries[:batch]`` at both slot
    widths over ``stores``; one record and one line per kernel and store.
    Raises after the last line if a kernel differed from its plain
    version (or a full step from the production kernel)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    timer = device_ms if on_card else host_ms
    names = list(steps or sl.MIN_STEPS)
    if BASELINE not in names:
        names.insert(0, BASELINE)
    kernels = probe_kernels([sl.MIN_STEPS[n] for n in names])
    q = torch.tensor(np.asarray(queries[:batch], np.float32), device=device)
    records, bad = [], []
    if sass and on_card:
        counts = kernel_sass()
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
    occ = ({n: sl.min_step_occupancy(s, M) for n, (_, _, s) in
            kernels.items() if s is not None} if on_card else {})
    for gran in (CHUNK, RCHUNK):
        args = index.scan_inputs(q, params, gran)
        B, S = args[4].shape
        every = bank_stores(args[2], args[3])
        empty = (args[4][:, :1] * 0, args[5][:, :1] * 0, args[6][:, :1] * 0)
        fill = int(args[5].sum()) / (B * S * gran)
        for store in stores:
            a = (*args[:2], *every[store], *args[4:])
            bnd = scan_bound(a, B * S, M + 1, M + 2)
            looks, waves = lookup_wavefronts(a[2], a[3], a[4], a[5], gran)
            floor = lookup_ms(looks, device)
            records.append({"name": "lookups", "gran": gran, "store": store,
                            "lookups": looks, "wavefronts": waves,
                            "lookup_ms": floor,
                            "lookup_conflict_ms": lookup_ms(32 * waves,
                                                            device)})
            log(f"{tag} lookups gran={gran} {store}: {looks} lookups in "
                f"{waves} shared-memory wavefronts of 32 words "
                f"({32 * waves / max(looks, 1):.3f} a lookup): "
                + ("the lookup floor at one word per bank per clock "
                   f"{floor:.4f} ms, with this store's bank conflicts "
                   f"{records[-1]['lookup_conflict_ms']:.4f} ms"
                   if on_card else "[host]"))
            prod = tk.adc_scan_slots_min(*a, gran)
            plains, plain_ms = {}, {}
            fa = kernels[BASELINE][0]
            for name, (fn, plain, st) in kernels.items():
                key = st.mode if st is not None else "full"
                if key not in plains:
                    plains[key] = plain(a, gran)
                    plain_ms[key] = timer(lambda: plain(a, gran), reps=1,
                                          warmup=0)
                out = fn(a, gran)
                equal = bool(torch.equal(out, plains[key]))
                err = max_abs_err(out, plains[key])
                if key == "full":
                    equal = equal and bool(torch.equal(out, prod))
                del out
                rec = {"name": name, "gran": gran, "store": store, "B": B,
                       "slots": S, "lane_fill": fill, "equal_plain": equal,
                       "max_abs_err": err, "plain_ms": plain_ms[key], **bnd,
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
                if store == "real" and key == "full":
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
    split = split_lines(records)
    for line in split:
        log(f"{tag} {line}")
    if bad:
        raise AssertionError(f"min probe: kernels differ from their plain "
                             f"versions: {bad}")
    return records


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |out - ref| over the finite entries of ``ref``; +inf where the
    +inf patterns differ."""
    if not torch.equal(torch.isinf(out), torch.isinf(ref)):
        return float("inf")
    fin = torch.isfinite(ref)
    return float((out[fin] - ref[fin]).abs().max()) if fin.any() else 0.0


def split_lines(records: list) -> list:
    """One line per slot width: the first port on the real store, and what
    each part takes in turns beside it (compute only, loads only, the
    conflict-free store, staging alone), then the same for the production
    kernel (comp_new, loads_new: its compute-only and loads-only modes)."""
    out = []
    by = {(r["name"], r["gran"], r["store"]): r for r in records
          if "ms" in r}
    for gran in (CHUNK, RCHUNK):
        parts = []
        for name, store in (("comp", "real"), ("loads", "real"),
                            (BASELINE, "free"), ("comp_new", "real"),
                            ("loads_new", "real"), (PRODUCTION, "real"),
                            ("comp_new", "free"), (PRODUCTION, "free")):
            r = by.get((name, gran, store))
            if r and "over_first_port" in r:
                parts.append(f"{name}/{store} {r['ms']:.4f} "
                             f"({r['over_first_port']:.3f}x)")
            elif r:
                parts.append(f"{name}/{store} {r['ms']:.4f}")
        base = by.get((BASELINE, gran, "real"))
        if base and parts:
            out.append(f"split gran={gran}: {BASELINE}/real "
                       f"{base['ms']:.4f} ms, staging alone "
                       f"{base.get('staging_ms', float('nan')):.4f}; "
                       + ", ".join(parts))
    return out


def siftlike_index(device, nb: int = 2_000_000, nq: int = 8192):
    """The primary point's IVFADC index over ``SiftLikeCorpus(65536,
    seed=1)``, drawn and trained as phase 16 of ``chip_smoke.py`` draws and
    trains it (300k rows for the centroids, 64k for PQ); returns (index,
    queries, search parameters)."""
    from ivfhnsw_tpu_torch import IVFADCIndex
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams
    from ivfhnsw_tpu_torch.utils.siftlike import D, SiftLikeCorpus
    from concurrent.futures import ThreadPoolExecutor
    corpus = SiftLikeCorpus(n_classes=65536, seed=1)
    per = 125_000                     # phase 16's draw: batch i, seed 100 + i
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        base = np.concatenate(list(ex.map(
            lambda i: corpus.batch(per, seed=100 + i),
            range(-(-nb // per)))))[:nb]
    queries = corpus.batch(nq, seed=9999)
    idx = IVFADCIndex(IndexConfig(d=D, nc=4096, code_size=16), device)
    gen = torch.Generator(device=device).manual_seed(0)
    idx.train_centroids(gen, base[:300_000], niter=10)
    idx.train_pq(gen, base[:65_536])
    step = C.ASSIGN_BATCH
    ids = np.arange(nb, dtype=np.int32)
    for o in range(0, nb, step):
        idx.add_batch(base[o:o + step], ids[o:o + step],
                      idx.assign(base[o:o + step]))
    idx.finalize()
    return idx, queries, SearchParams(k=10, nprobe=32, max_codes=10000)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"device": "cuda", "nb": "2000000", "batch": "8192",
            "corpus": "primary", "stores": "real,free", "rounds": "6",
            "steps": ",".join(sl.MIN_STEPS)}
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
    print(json.dumps({"mprobe": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
