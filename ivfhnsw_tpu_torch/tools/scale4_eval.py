"""The scale4 stage's evaluation off a cached 268M build: the counterpart
of the root ``tools/scale4_eval.py``.

It loads the build through ``bench.build_scale4``'s cached branch (it
refuses to start one: a fresh build is scale3sl's and then 134M rows more,
``tools/warm_cache.py scale3sl`` then ``scale4``), caches the exact-ADC
ceiling first (``bench.stage_ceiling``, the file a bench run reuses), then
runs ``bench.eval_scale4``, the function the bench stage calls: the timed
sustained and single-launch runs and the device memory in use. The record
holds eval_scale4's fields and ``load_seconds``, ``timed_seconds``,
``device`` and ``recorded_at``; it is written atomically to
``<cache>/scale4/eval.json`` and printed as one JSON line.

    python -m ivfhnsw_tpu_torch.tools.scale4_eval [--device cuda] [--smoke]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from ivfhnsw_tpu_torch.tools import bench, scale3

# The fields of eval_scale4 that are measured (times, the process's peak
# host RSS) and so differ between two runs on the same build; every other
# field is a function of the build.
TIMED = ("scale4_qps_nprobe128_mc100k", "scale4_us_per_query",
         "scale4_us_per_query_single_launch", "scale4_ceiling_seconds",
         "scale4_host_peak_rss_gib")


def run(S: dict, device, cache: str, smoke: bool = False) -> dict:
    """The record of the cached build in ``cache``; writes eval.json."""
    if not bench._all_present(cache, bench.NEED["scale4"].probe[:1]):
        raise SystemExit(f"scale4_eval: no scale4 build in {cache}; run "
                         "tools/warm_cache.py scale3sl scale4 first")
    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        idx, q, gt, meta = bench.build_scale4(S, device, cache)
        load_s = time.perf_counter() - t
        bench.log(f"scale4_eval: loaded the cached build in {load_s:.1f} s")
        try:
            ceil, ceil_s = bench.stage_ceiling("scale4", idx, q, gt, cache)
            bench.log(f"scale4_eval: ceiling {ceil} ("
                      + ("cached" if ceil_s is None else f"{ceil_s:.1f} s")
                      + ")")
            t = time.perf_counter()
            fields = bench.eval_scale4(idx, q, gt, meta, S, cache, smoke)
        finally:
            idx.release_device()
    out = {**fields, "load_seconds": load_s,
           "timed_seconds": time.perf_counter() - t,
           "device": bench.device_line(device), "recorded_at": bench._utc()}
    bench._dump(os.path.join(cache, "scale4", "eval.json"), out)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.scale4_eval",
        description="Evaluate the cached scale4 build as the bench stage "
                    "does.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's BENCH_SMOKE sizes (also BENCH_SMOKE=1)")
    args = ap.parse_args(argv)
    device = scale3.resolve_device(args.device)
    smoke = args.smoke or scale3.smoke()
    out = run(bench.sizes(smoke), device, bench.cache_root(smoke), smoke)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
