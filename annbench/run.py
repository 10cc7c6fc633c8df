"""Run one cell of the benchmark once and print its result line.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result object; the last lines of
standard error are the numbers the check compared, each beside its limit.
Needs a CUDA device (as many as the cell's ``chips``); exits non-zero and
prints no result without one.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    sys.path.insert(0, ROOT)
    import torch
    from annbench import harness
    chips = harness.load_cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", bench, T0)
    found = harness.forbidden_modules()
    if found:
        print(f"modules loaded that the run must not load: {found}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
