"""Toy copies of the benchmark's cells for the CPU tests: the same files,
the same code, sizes a test run can hold."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

TOY_CONFIG = {"nb": 16384, "chunk_rows": 4096, "nsubt": 4096, "pq_niter": 4}
TOY_NC = {"ivfadc": 64, "grouping": 32}
TOY_SEARCH = {"nprobe": 8, "max_codes": 1000}
TOY_TRAFFIC = {"search_batch": {"queries": 256, "chunk": 64, "rotate": 25,
                                "warmup_calls": 1, "check_queries": 48,
                                "trace_first": 1, "trace_steps": 1,
                                "idle_first": 3, "idle_steps": 2},
               "add_closed": {"segment_rows": 2048, "pool_segments": 2,
                              "check_rows": 1024, "trace_first": 1,
                              "trace_steps": 1, "idle_first": 3,
                              "idle_steps": 1}}


def toy_base(tmp: str) -> str:
    """A copy of the benchmark's data files under ``tmp`` with every
    configuration and traffic mix cut to toy sizes; returns its path."""
    base = os.path.join(tmp, "annbench")
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(base, sub))
    for name in os.listdir(os.path.join(base, "configs")):
        path = os.path.join(base, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TOY_CONFIG, nc=TOY_NC[cfg["index"]], **TOY_SEARCH)
        if cfg["index"] == "grouping":
            cfg["nsubc"] = 8
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(base, "traffic")):
        path = os.path.join(base, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr.update(TOY_TRAFFIC[tr["kind"]])
        if "search" in tr:
            tr["search"].update({k: v for k, v in TOY_SEARCH.items()
                                 if k in tr["search"]})
        with open(path, "w") as f:
            json.dump(tr, f)
    return base


def bench() -> dict:
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        return json.load(f)
