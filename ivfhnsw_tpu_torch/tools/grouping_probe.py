"""The grouping probe: the design steps of the grouping scan kernel timed
against each other on the flagship's own schedule.

Run from the root of a checkout (it builds the flagship synthetic index, 2M
x 128d, nc=4096, nsubc=64, OPQ, code_size=16, and takes one 8192-query
batch's scan inputs with pruning on, nprobe=32, max_codes=10000):

    python -m ivfhnsw_tpu_torch.tools.grouping_probe [-device cuda]
        [-nb 2000000] [-batch 8192]

At each slot width (256 and 1024 codes) the engine's kernel
(``grouping_scan_slots``, ``csrc/grouping_scan.cu``) and every variant of
``ops/cuda/grouping_lab.py`` (``direct``: the kernel as first ported;
``fill``, ``fill_stream``, ``fill_stream_skip``, ``staged``: one design step
more each; ``skip``: the pruned-lane shortcut alone) is first held to
``torch.equal`` with the plain version, then timed (CUDA events, median of
20 after 3 warm-up launches), then timed against ``direct`` in turns (A B B
A, four rounds, the median of each side): the card's state drifts by a few
percent within a run, so only the in-turns ratio tells two kernels apart.
One ``[gprobe]`` line and one record per kernel; the run raises after the
last line if a kernel differed from the plain version. On ``-device cpu``
every wrapper runs the plain version and the times are the host's.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.cuda import grouping_lab as gl
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as gs
from ivfhnsw_tpu_torch.ops.cuda.adc_scan import CHUNK, RCHUNK
from ivfhnsw_tpu_torch.utils.timer import device_ms, host_ms

ENGINE = "grouping_scan_slots"
BASELINE = "direct"


def probe_kernels() -> dict:
    """name -> fn(args, gran) of the probed kernels: the engine's (with
    the bin minima the search asks of it; its lanes returned), then the
    lab's variants."""
    out = {ENGINE: lambda a, g: gs.grouping_scan_slots(*a, g, bins=True)[0]}
    for name in gl.VARIANTS:
        out[f"lab_{name}"] = (
            lambda a, g, name=name: gl.grouping_lab_scan(name, *a, g))
    return out


def run(index, queries: np.ndarray, params, device, batch: int = 8192,
        reps: int = 20, rounds: int = 4, log=print) -> list:
    """Every probed kernel on the scan inputs of ``queries[:batch]`` at
    both slot widths; one record and one line per kernel. Raises after the
    last line if a kernel differed from the plain version."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    timer = device_ms if on_card else host_ms
    q = torch.tensor(np.asarray(queries[:batch], np.float32), device=device)
    kernels = probe_kernels()
    base = f"lab_{BASELINE}"
    records, bad = [], []
    for gran in (CHUNK, RCHUNK):
        args = index.grouping_scan_inputs(q, params, gran)
        B, S = args[6].shape
        ref = gs.grouping_scan_slots_plain(*args, gran)
        fin = torch.isfinite(ref)
        for name, fn in kernels.items():
            out = fn(args, gran)
            equal = bool(torch.equal(out, ref))
            err = float((out[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
            del out
            ms = timer(lambda: fn(args, gran), reps=reps)
            rec = {"name": name, "gran": gran, "B": B, "slots": S, "ms": ms,
                   "equal_plain": equal, "max_abs_err": err,
                   "timer": "cuda_events" if on_card else "host"}
            if name != base:
                t = {name: [], base: []}
                for k in (name, base, base, name) * rounds:
                    t[k].append(timer(lambda: kernels[k](args, gran),
                                      reps=reps))
                med = {k: statistics.median(v) for k, v in t.items()}
                rec.update(ms_in_turns=t, median_ms=med[name],
                           baseline_median_ms=med[base],
                           over_baseline=med[name] / med[base])
            records.append(rec)
            if not equal:
                bad.append(f"{name}@{gran}")
            turns = ("" if name == base else
                     f"; in turns {rec['median_ms']:.4f} ms against "
                     f"{BASELINE} {rec['baseline_median_ms']:.4f} ms: "
                     f"{rec['over_baseline']:.3f}x")
            log(f"[gprobe] {name:<22} gran={gran} B={B} slots={S}: "
                f"{ms:.4f} ms{turns}; torch.equal to plain: {equal}"
                + ("" if on_card else " [host]"))
        # The fill alone: every kernel on a schedule of empty slots (tables
        # staged, every row +inf), beside one PyTorch fill of a tensor of
        # the output's shape, the card's own rate for such a write (a
        # yardstick: it computes no scan).
        empty = (*args[:6], torch.zeros_like(args[6]),
                 torch.zeros_like(args[7]), *args[8:])
        buf = torch.empty_like(ref)
        fills = {name: timer(lambda: fn(empty, gran), reps=reps)
                 for name, fn in kernels.items()}
        fills["torch_fill"] = timer(lambda: buf.fill_(float("inf")),
                                    reps=reps)
        records.append({"name": "empty_schedule", "gran": gran, "B": B,
                        "slots": S, "out_bytes": ref.numel() * 4,
                        "ms": fills})
        log(f"[gprobe] empty schedule gran={gran}, {ref.numel() * 4 / 1e9:.3f}"
            " GB of +inf: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in fills.items()) + " ms")
        del ref, buf, fin
    if bad:
        raise AssertionError(f"grouping probe: kernels differ from the plain "
                             f"version: {bad}")
    return records


def flagship_index(device, nb: int = 2_000_000, nq: int = 8192):
    """The flagship synthetic index (128d, nc=4096, nsubc=64, OPQ,
    code_size=16, seed 0) over ``nb`` vectors on ``device``, built by
    ``drivers/grouping_eval.py::build``; returns (index, queries [nq, 128],
    search parameters)."""
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.drivers import grouping_eval
    cfg, extras = C.parse_driver_args(("synthetic", "device"), [
        "-synthetic", "0", "-device", str(device), "-d", "128", "-nc", "4096",
        "-code_size", "16", "-nsubc", "64", "-do_opq", "on", "-do_pruning",
        "on", "-nb", str(nb), "-nt", "200000", "-nq", str(nq), "-k", "10",
        "-nprobe", "32", "-max_codes", "10000"])
    index, ds, _ = grouping_eval.build(cfg, extras)
    return index, ds.queries, cfg.search


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"device": "cuda", "nb": "2000000", "batch": "8192"}
    while argv:
        flag = argv.pop(0)
        if not flag.startswith("-") or flag[1:] not in opts or not argv:
            raise SystemExit(__doc__)
        opts[flag[1:]] = argv.pop(0)
    device = torch.device(opts["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {opts['device']}: no CUDA device is "
                           "available; pass -device cpu to run on the CPU")
    index, queries, params = flagship_index(device, int(opts["nb"]),
                                            int(opts["batch"]))
    on_card = device.type == "cuda"
    records = run(index, queries, params, device, batch=int(opts["batch"]),
                  reps=20 if on_card else 1, rounds=4 if on_card else 1)
    print(json.dumps({"gprobe": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
