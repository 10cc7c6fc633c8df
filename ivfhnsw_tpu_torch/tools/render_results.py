"""Render the port's bench table in README.md from its committed snapshot:
the counterpart of the root ``tools/render_results.py``.

The table between the TORCH_BENCH_TABLE markers in README.md is generated
from ``RESULTS_TORCH_LATEST.json``, so no number in it is typed by hand.
The snapshot holds, per stage, the fields of the bench record that last
measured it (``ivfhnsw_tpu_torch/tools/bench.py``'s ``stages_done`` and
``stage_keys``) with that record's ``device`` line (nvidia-smi's name and
power limit), ``smoke`` and ``recorded_at``. The twelve stages do not all
fit one run under a one-hour limit, so ``--snapshot`` merges records stage
by stage; a stage that no record measured renders as "not measured".
There is no fall-back to a committed record of the JAX side: this tool
reads only the README, the snapshot and the records it is given.

    python -m ivfhnsw_tpu_torch.tools.render_results            # rewrite
    python -m ivfhnsw_tpu_torch.tools.render_results --check    # exit 1
        if the table is stale
    python -m ivfhnsw_tpu_torch.tools.render_results --snapshot REC ...
        (each REC a bench record: last_result.json, or the command's
        stdout, whose last line is the record; merged, then rendered)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ivfhnsw_tpu_torch.tools.scale3 import ROOT

README = os.path.join(ROOT, "README.md")
RESULTS = os.path.join(ROOT, "RESULTS_TORCH_LATEST.json")
START = ("<!-- TORCH_BENCH_TABLE_START (generated by "
         "ivfhnsw_tpu_torch/tools/render_results.py) -->")
END = "<!-- TORCH_BENCH_TABLE_END -->"

# stage -> (what it runs, field prefix, recall ks); in STAGES_ALL's order
ROWS = {
    "primary": ("IVFADC 2M × 128d, nc 4096, nprobe 32, max_codes 10k", "",
                (1, 10, 100)),
    "grouping": ("the same with Grouping + Pruning + OPQ, nsubc 64",
                 "grouping_", (1, 10, 100)),
    "scale": ("20M × 128d, nc 2^17, nprobe 128, max_codes 30k", "scale_",
              (1, 10, 100)),
    "deep": ("20M × 96d (PQ16, dsub 6), nc 2^17, nprobe 128", "deep_",
             (1, 10, 100)),
    "siftlike": ("2M SIFT-like, the primary point", "siftlike_",
                 (1, 10, 100)),
    "scale3sl": ("134M SIFT-like, nc 2^20, nprobe 128, max_codes 100k",
                 "scale3sl_", (1, 10, 100)),
    "scale4": ("268M SIFT-like on one card, nc 2^20, nprobe 128",
               "scale4_", (1, 10, 100)),
    "grouping_scale": ("33.5M SIFT-like, nc 2^17, nsubc 64, OPQ, pruning",
                       "grouping_scale_", (1, 10, 100)),
    "search_1b": ("the 1B search (report of tools/search_1b.py)",
                  "search_1b_", (1, 10, 100)),
    "scale2": ("134M two-level corpus, nc 2^17, nprobe 128",
               "scale2_", (1, 10, 100)),
    "scale3": ("134M, nc 2^20, routed assignment and coarse", "scale3_",
               (1, 10, 100)),
    "build_1b": ("the 1B build (report of tools/build_1b.py)", "build_1b_",
                 ())}
# stage -> (label, field) of the notes column
NOTES = {
    "primary": (("vs C++ baseline", "vs_baseline"),
                ("baseline µs/query", "cpu_baseline_us_per_query")),
    "siftlike": (("vs C++ baseline", "siftlike_vs_baseline"),
                 ("baseline µs/query", "siftlike_cpu_us_per_query")),
    "scale3sl": (("R@1 / ceiling", "scale3sl_recall_frac_of_ceiling_at_1"),
                 ("assignment", "scale3sl_assignment_mode")),
    "scale4": (("device GiB in use", "scale4_hbm_in_use_gb"),
               ("extend s", "scale4_extend_seconds"),
               ("host peak RSS GiB", "scale4_host_peak_rss_gib")),
    "grouping_scale": (("µs/query pruning off",
                        "grouping_scale_us_per_query_pruning_off"),
                       ("assignment", "grouping_scale_assignment_mode")),
    "search_1b": (("nb", "search_1b_nb"), ("shards", "search_1b_shards"),
                  ("source", "search_1b_source")),
    "scale2": (("assignment", "scale2_assignment_mode"),),
    "scale3": (("assignment", "scale3_assignment_mode"),
               ("coarse", "scale3_coarse")),
    "build_1b": (("vectors", "build_1b_vectors"),
                 ("vectors/s", "build_1b_vectors_per_sec"),
                 ("source", "build_1b_source"))}


def _num(v, digits: int = 4) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


def _row(stage: str, entry: dict | None) -> str:
    what, pre, ks = ROWS[stage]
    if entry is None:
        return f"| {stage} | {what} | not measured | | | | | |"
    f = entry["fields"]
    us = f.get(pre + "us_per_query", f.get(pre + "us_per_query_total"))
    single = f.get(pre + "us_per_query_single_launch")
    speed = _num(us) + (f" / {_num(single)}" if single is not None else "")
    ceil_key = ("recall_ceiling_at_" if stage == "primary"
                else pre + "ceiling_at_")
    rec = " / ".join(_num(f.get(f"{pre}recall_at_{k}")) for k in ks)
    ceil = [f.get(f"{ceil_key}{k}") for k in ks]
    if any(c is not None for c in ceil):
        rec += " (ceiling " + " / ".join(_num(c) for c in ceil) + ")"
    # build_1b's report names its build time build_1b_seconds (bench.py)
    build = f.get(pre + "build_seconds", f.get(pre + "seconds")) if pre \
        else None
    notes = "; ".join(f"{label} {_num(f.get(key))}"
                      for label, key in NOTES.get(stage, ()))
    card = entry["device"] + (", smoke sizes" if entry.get("smoke") else "")
    return (f"| {stage} | {what} | {speed} | {rec or '—'} | "
            f"{_num(build, 1)} | {_num(f.get(stage + '_stage_seconds'), 1)}"
            f" | {notes or '—'} | {card}, {entry['recorded_at']} |")


def render(snap: dict) -> str:
    """The table of ``snap`` (the snapshot's contents), one row a stage."""
    head = ("Rendered by `ivfhnsw_tpu_torch/tools/render_results.py` from "
            "`RESULTS_TORCH_LATEST.json`: each row holds the fields of the "
            "bench record that last measured the stage, beside that "
            "record's card (nvidia-smi name and power limit) and time. "
            "µs/query: sustained (8 launches per synchronize) / single "
            "launch; build and stage in seconds.\n\n"
            "| stage | what | µs/query | R@1 / R@10 / R@100 | build s | "
            "stage s | notes | measured on |\n"
            "|---|---|---|---|---|---|---|---|")
    stages = snap.get("stages", {})
    return head + "\n" + "\n".join(_row(s, stages.get(s)) for s in ROWS)


def _record(path: str) -> dict:
    """A bench record: the file's last non-empty line, as JSON."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def merge(snap: dict, rec: dict) -> dict:
    """``snap`` with each stage of ``rec``'s ``stages_done`` replaced by its
    fields and the record's device, smoke flag and time."""
    stages = dict(snap.get("stages", {}))
    for st in rec.get("stages_done", []):
        stages[st] = {"fields": {k: rec[k] for k in rec["stage_keys"][st]},
                      "device": rec["device"], "smoke": rec["smoke"],
                      "recorded_at": rec["recorded_at"]}
    return {**snap, "stages": {s: stages[s] for s in ROWS if s in stages}}


def update(readme: str, results: str, check: bool = False) -> bool:
    """Render ``results`` into ``readme`` between the markers (with
    ``check``, only compare). True when the table was already current."""
    with open(results) as f:
        table = render(json.load(f))
    with open(readme) as f:
        doc = f.read()
    if START not in doc or END not in doc:
        raise SystemExit(f"{readme} lacks the {START} / {END} markers")
    pre, rest = doc.split(START, 1)
    post = rest.split(END, 1)[1]
    new = pre + START + "\n" + table + "\n" + END + post
    if not check and new != doc:
        with open(readme, "w") as f:
            f.write(new)
    return new == doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.render_results",
        description="Render the port's bench table from its snapshot.")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the README's table is stale")
    ap.add_argument("--snapshot", nargs="+", metavar="RECORD",
                    help="merge these bench records into the snapshot first")
    ap.add_argument("--readme", default=README)
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    if args.snapshot:
        snap = {}
        if os.path.exists(args.results):
            with open(args.results) as f:
                snap = json.load(f)
        for path in args.snapshot:
            snap = merge(snap, _record(path))
        with open(args.results, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
    current = update(args.readme, args.results, check=args.check)
    if args.check and not current:
        print(f"{args.readme}'s port table is stale: run python -m "
              "ivfhnsw_tpu_torch.tools.render_results", file=sys.stderr)
        return 1
    said = "matches" if current else "rendered from"
    print(f"{args.readme}'s port table {said} {args.results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
