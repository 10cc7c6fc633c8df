"""Traffic kind ``search_batch``: big-ann-benchmarks' batch mode. Each call
hands the whole query set (``queries`` held-out queries) to
``search_device``, which searches it ``chunk`` queries at a time on the
device, and waits for the labels on the host, as that benchmark's runner
does in batch mode; the calls follow one another for the window. Call j
gets the set rotated to start at query (j * ``rotate``) mod ``queries``: the
same queries in another order, so an answer left over from an earlier call
is wrong."""

from __future__ import annotations

import contextlib
import time

import torch

JUDGE = "search"


def prepare(run) -> None:
    tp = run.traffic
    q = run.dep.queries(tp["queries"])
    run.state["pool_q"] = q
    run.state["qext"] = torch.cat([q, q]).contiguous()
    run.state["params"] = run.system.search_params(run.cfg)
    for j in range(tp["warmup_calls"]):
        _, l = _search(run, j)
        l.cpu()
    run.sync()


def _offset(run, j: int) -> int:
    return j * run.traffic["rotate"] % run.traffic["queries"]


def _search(run, j: int):
    o = _offset(run, j)
    return run.idx.search_device(
        run.state["qext"][o:o + run.traffic["queries"]], run.state["params"],
        batch=run.traffic["chunk"])


def window(run, seconds: float, tracer) -> dict:
    nq = run.traffic["queries"]
    outs = []
    dispatch_s, call_s = 0.0, []
    j = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if tracer is not None:
            tracer.before(j)
        with (tracer.span(j) if tracer is not None
              else contextlib.nullcontext()):
            td = time.perf_counter()
            d, l = _search(run, j)
            tr = time.perf_counter()
            l.cpu()                 # the call's answer, on the host
            tc = time.perf_counter()
        if tracer is None or not tracer.covers(j):
            dispatch_s += tr - td
            call_s.append(tc - td)
        if tracer is not None:
            tracer.after(j)
        outs.append((d, l))
        j += 1
    elapsed = time.perf_counter() - t0
    if tracer is not None:
        tracer.stop()
    run.state["outs"] = outs
    return {"e2e": {"qps": j * nq / elapsed},
            "attempted": j * nq, "failed": 0,
            "host": {"dispatch_s": dispatch_s, "call_s": call_s, "calls": j,
                     "elapsed_s": elapsed}}


def answers(run, sample: torch.Tensor):
    """(D, L, owner) of every window answer to a sampled query: owner[i]
    indexes ``sample``."""
    nq = run.traffic["queries"]
    D, L, O = [], [], []
    own = torch.arange(sample.numel(), device=sample.device)
    for j, (d, l) in enumerate(run.state.pop("outs")):
        at = (sample - _offset(run, j)) % nq
        D.append(d[at])
        L.append(l[at])
        O.append(own)
    return torch.cat(D), torch.cat(L), torch.cat(O)


def chunks(run, steps) -> list:
    """For each call in ``steps``, the indices into the query set of each
    chunk that ``search_device`` searches in it."""
    nq, B = run.traffic["queries"], run.traffic["chunk"]
    return [[(_offset(run, j) + torch.arange(s, min(s + B, nq),
                                             device=run.device)) % nq
             for s in range(0, nq, B)] for j in steps]
