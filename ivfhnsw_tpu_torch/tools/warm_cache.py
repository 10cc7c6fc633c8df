"""Warm the bench cache for the costliest stages, in priority order: the
counterpart of the root ``tools/warm_cache.py``.

For each stage it calls the bench tool's builder (``build_<stage>``, which
loads what the cache holds and builds the rest) and then caches the
stage's exact-ADC ceiling in ``<cache>/<stage>/ceiling.json`` through
``bench.stage_ceiling``, the evaluation's own definition (k = 1, 10 for
scale4; 1, 10, 100 for the rest), so that a bench run finds every probe
file of the stage and prices it warm. It then releases the device. Before
the first stage it takes the cache as a bench run does
(``bench.take_cache``: the lock, and the corpus version stamped), so the
next bench run does not wipe what it warmed. Safe to kill: every finished
sub-artifact (centroids, quantizers, index, ground truth, ceiling) stays
and is reused by the next run.

One JSON line per stage on stdout: ``stage``, ``build`` ("cached" when the
stage's index was already there, else "built"), ``ceiling`` ("cached" or
"computed"), ``seconds``, ``ceiling_seconds``.

    python -m ivfhnsw_tpu_torch.tools.warm_cache [stage ...]
        [--device cuda] [--smoke]

The default order is JAX's: scale3sl grouping_scale scale4 scale2 scale3.
A build that does not fit one call can be split: ``warm_cache scale3sl`` in
one, ``warm_cache scale4`` (the extension, written beside it) in the next,
when the cache directory survives between them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import torch

from ivfhnsw_tpu_torch.tools import bench, scale3

ORDER = ("scale3sl", "grouping_scale", "scale4", "scale2", "scale3")


def warm(stage: str, S: dict, device, cache: str) -> dict:
    """Build or load ``stage``, cache its ceiling, release the device."""
    t = time.perf_counter()
    built = not os.path.exists(os.path.join(cache, bench.NEED[stage].probe[0]))
    bench.log(f"warm: {stage} ({'build' if built else 'cached build'}) ...")
    with contextlib.redirect_stdout(sys.stderr):
        idx, q, gt, _ = bench.STAGES[stage][0](S, device, cache)
        try:
            _, ceil_s = bench.stage_ceiling(stage, idx, q, gt, cache)
        finally:
            idx.release_device()
    del idx, q, gt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"stage": stage, "build": "built" if built else "cached",
           "ceiling": "cached" if ceil_s is None else "computed",
           "seconds": time.perf_counter() - t, "ceiling_seconds": ceil_s}
    bench.log(f"warm: {stage} done in {out['seconds']:.1f} s")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.warm_cache",
        description="Build the bench cache and the ceilings of the named "
                    "stages ahead of a bench run.")
    ap.add_argument("stages", nargs="*", default=list(ORDER),
                    help="of " + ", ".join(ORDER))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's BENCH_SMOKE sizes (also BENCH_SMOKE=1)")
    args = ap.parse_args(argv)
    bad = [s for s in args.stages if s not in ORDER]
    if bad:
        ap.error(f"unknown stages {bad}; choose from {list(ORDER)}")
    device = scale3.resolve_device(args.device)
    smoke = args.smoke or scale3.smoke()
    S, cache = bench.sizes(smoke), bench.cache_root(smoke)
    lock, _ = bench.take_cache(cache)
    out = []
    try:
        for stage in args.stages:
            out.append(warm(stage, S, device, cache))
            print(json.dumps(out[-1]), flush=True)
    finally:
        lock.close()
    return out


if __name__ == "__main__":
    main()
