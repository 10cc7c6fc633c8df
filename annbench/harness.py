"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

A cell is found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``);
the configuration names the system (``systems/<index>.py``) and its
reference (``reference/<reference>.py``, by default ``<index>``), the
traffic its kind (``loops/<kind>.py``) and, optionally, the cell's search
operating point; each per-layer metric is ``metrics/<metric>.py``;
``BENCHMARK.json`` says which metrics a cell reports. Adding any of them is
adding files.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import torch

from annbench.gen.deployment import Deployment, generator
from annbench.reference import judge as J
from annbench.trace import Trace, Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ivfhnsw_tpu")
# What a traffic mix's "search" object may set over its configuration.
SEARCH_KEYS = ("nprobe", "max_codes", "do_pruning")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, base: str = HERE) -> dict:
    """{"cell", "config", "traffic", "chips"} of cell ``name``. The
    traffic's ``search`` object (only ``SEARCH_KEYS``) sets the cell's
    operating point over its configuration's: the system, the reference,
    the control and the metric readers all read it from "config"."""
    w = _json(os.path.join(base, "workloads", f"{name}.json"))
    cfg = _json(os.path.join(base, "configs", f"{w['config']}.json"))
    tr = _json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    point = tr.get("search", {})
    if not isinstance(point, dict) or set(point) - set(SEARCH_KEYS):
        raise ValueError(f"traffic {w['traffic']}: 'search' may set only "
                         f"{list(SEARCH_KEYS)}, got {point!r}")
    cfg.update(point)
    return {"cell": w, "config": cfg, "traffic": tr, "chips": w["chips"]}


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of BENCHMARK.json that cell ``cell`` reports."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_metric(name: str, base: str = HERE):
    spec = importlib.util.spec_from_file_location(
        "annbench_metric_" + name.replace(".", "_"),
        os.path.join(base, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a cell's set-up made, handed to its traffic kind."""

    def __init__(self, spec: dict, seed: int, device, log):
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.device, self.log = seed, torch.device(device), log
        self.system = importlib.import_module(
            f"annbench.systems.{self.cfg['index']}")
        self.reference = J.reference_module(self.cfg)
        self.loop = importlib.import_module(
            f"annbench.loops.{self.traffic['kind']}")
        self.state: dict = {}
        self.dep = self.idx = self.cb = self.norms = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        self.dep = Deployment(self.cfg, self.seed, self.device)
        self.cb, self.norms = self.dep.quantizers()
        self.idx = self.system.build(self.dep, self.cb, self.norms, self.log)
        self.loop.prepare(self)
        self.sync()


class MetricCtx:
    """What a per-layer metric reader sees: the reduced traces (``trace``,
    the layers stretch with the Python stack; ``device``, the longer
    stretch without it), the host's readings of the window, the run, the
    reference, and for each call of the layers stretch the chunks of
    queries it searched."""

    def __init__(self, run: Run, trace: Trace | None, host: dict,
                 ref, chunks: list, device: Trace | None = None):
        self.run, self.trace, self.host, self.ref = run, trace, host, ref
        self.chunks, self.device = chunks, device


def _check_search(run: Run):
    """Numbers of the search check, and the reference that made them."""
    tp = run.traffic
    g = generator(run.device, run.seed, "check")
    sample = torch.randperm(tp["queries"], generator=g,
                            device=run.device)[:tp["check_queries"]]
    D, L, owner = run.loop.answers(run, sample)
    state = run.system.judge_state(run.idx)
    Qs = run.state["pool_q"][sample]
    run.idx = None
    _free(run)
    nums, ref = run.reference.judge_search(run.cfg, run.dep, run.cb,
                                           run.norms, Qs, D, L, owner, state)
    for k, v in getattr(ref, "notes", {}).items():
        run.log(f"{k} {v!r}")
    return nums, ref


def _check_add(run: Run):
    """Numbers of the add check (no reference is kept)."""
    tp = run.traffic
    g = generator(run.device, run.seed, "check")
    ids, seg, row = run.loop.added(run, tp["check_rows"], g)
    store = run.idx.store
    sid, order = torch.sort(store.ids_t.long())
    pos = torch.searchsorted(sid, ids).clamp_max(sid.numel() - 1)
    nxt = (pos + 1).clamp_max(sid.numel() - 1)
    found = (sid[pos] == ids) & ((pos + 1 >= sid.numel()) | (sid[nxt] != ids))
    r = order[pos]
    keys = torch.searchsorted(store.list_offsets_t, r, right=True) - 1
    codes, ncodes = store.codes_t[r], store.norm_codes_t[r]
    missing = int((~found).sum())
    del sid, order, store
    run.idx = None
    run.state.pop("pool", None)
    _free(run)
    x = torch.empty((ids.numel(), run.dep.d), device=run.device)
    for j in torch.unique(seg).tolist():
        m = seg == j
        x[m] = run.dep.segment(j, tp["segment_rows"])[row[m]]
    return run.reference.judge_add(run.cfg, run.dep, run.cb, run.norms,
                                   x[found], keys[found], codes[found],
                                   ncodes[found], missing), None


# The check of each kind of judgement a loop asks for (its ``JUDGE``).
CHECKS = {"search": _check_search, "add": _check_add}


def _free(run: Run) -> None:
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench: dict, t_start: float, log=None, base: str = HERE) -> dict:
    """One run of cell ``name``; returns the result object (not printed)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    spec = load_cell(name, base)
    run = Run(spec, seed, device, log)
    log("operating point: " + ", ".join(f"{k} {run.cfg.get(k)!r}"
                                        for k in SEARCH_KEYS))
    run.setup()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    tracer = (Tracer(run.traffic, run.device.type == "cuda") if trace
              else None)
    win = run.loop.window(run, seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the run must not load: {found}")
    chunks = []
    if trace and hasattr(run.loop, "chunks"):
        tr = run.traffic
        chunks = run.loop.chunks(run, range(
            tr["trace_first"], tr["trace_first"] + tr["trace_steps"]))
    kind = run.loop.JUDGE
    limits = run.cfg["limits"][kind]
    t_check = time.perf_counter()
    nums, ref = CHECKS[kind](run)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    checks = {k: {"value": J.worst(v), "limit": limits[k]}
              for k, v in nums.items()}
    correct = all(nums[k] <= limits[k] for k in nums)
    metrics = {}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win["attempted"],
           "failed": win["failed"]}
    if trace:
        t_read = time.perf_counter()
        T = tracer.traces()
        ctx = MetricCtx(run, T["layers"], win["host"], ref, chunks,
                        T["device"])
        for m in cell_metrics(bench, name, True):
            v = load_metric(m["name"], base).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        D = T["device"]
        if D is not None:
            w = D.window()
            device["busy_s"] = D.busy_us() * 1e-6
            device["window_s"] = (w[1] - w[0]) * 1e-6 if w else 0.0
            out["breakdown"] = D.breakdown()
        log(f"traces read {time.perf_counter() - t_read:.3f} s: " + ", ".join(
            f"{k} {t.n_steps} steps {len(t.ops)} device ops"
            if t is not None else f"{k} none" for k, t in T.items()))
    else:
        e2e = dict(win["e2e"], setup_s=setup_s)
        for m in cell_metrics(bench, name, False):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device
    out["checks"] = checks
    return out
