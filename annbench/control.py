"""The control of a cell's check: the plain reference put in the program's
place, in the precision just below the configuration's (TF32 for float32
with TF32 off), judged by the same comparison as the program. It has to
come out not correct. Not part of a benchmark run.

    python3 annbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--precision tf32|f32]

Prints one JSON line per seed: the numbers compared, their limits, and
whether the control came out correct. ``--precision f32`` runs the same
reference at the configuration's own precision, which has to pass.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _control_search(R, cfg, tp, dep, cb, norms, g, prec: str) -> dict:
    import torch
    pool_q = dep.queries(tp["queries"])
    sample = torch.randperm(tp["queries"], generator=g,
                            device=dep.device)[:tp["check_queries"]]
    Qs = pool_q[sample]
    D, L, state = R.control_search(cfg, dep, cb, norms, Qs, prec)
    owner = torch.arange(Qs.shape[0], device=dep.device)
    return R.judge_search(cfg, dep, cb, norms, Qs, D, L, owner, state)[0]


def _control_add(R, cfg, tp, dep, cb, norms, g, prec: str) -> dict:
    import torch
    n = tp["segment_rows"]
    m = min(tp["check_rows"], n * tp["pool_segments"])
    pick = torch.randperm(n * tp["pool_segments"], generator=g,
                          device=dep.device)[:m]
    seg, row = pick // n, pick % n
    x = torch.empty((m, dep.d), device=dep.device)
    for j in torch.unique(seg).tolist():
        x[seg == j] = dep.segment(j, n)[row[seg == j]]
    keys, codes, ncodes = R.control_add(cfg, dep, cb, norms, x, prec)
    return R.judge_add(cfg, dep, cb, norms, x, keys, codes, ncodes, 0)


# The control of each kind of judgement a traffic's loop asks for.
CONTROLS = {"search": _control_search, "add": _control_add}


def control_numbers(name: str, seed: int, prec: str, device,
                    base: str | None = None) -> dict:
    """The check's numbers with the reference in ``prec`` in the program's
    place, for cell ``name`` and seed ``seed``."""
    from annbench import harness
    from annbench.gen.deployment import Deployment, generator
    from annbench.reference import judge as J
    spec = harness.load_cell(name, base or harness.HERE)
    cfg, tp = spec["config"], spec["traffic"]
    judge = importlib.import_module(f"annbench.loops.{tp['kind']}").JUDGE
    dep = Deployment(cfg, seed, device)
    cb, norms = dep.quantizers()
    g = generator(dep.device, seed, "check")
    nums = CONTROLS[judge](J.reference_module(cfg), cfg, tp, dep, cb,
                           norms, g, prec)
    limits = cfg["limits"][judge]
    return {"cell": name, "seed": seed, "precision": prec,
            "correct": all(nums[k] <= limits[k] for k in nums),
            "checks": {k: {"value": J.worst(v), "limit": limits[k]}
                       for k, v in nums.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="tf32", choices=("tf32", "f32"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_numbers(args.workload, seed, args.precision, "cuda")
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
