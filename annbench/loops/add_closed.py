"""Traffic kind ``add_closed``: closed-loop ``add_batch_device`` of
``segment_rows``-row segments (the upstream adds in batches of 1M) into
the set-up index, with the program's exact assignment, then one
``finalize``, counted inside the window. The segments are drawn in set-up
as a pool of ``pool_segments``; a window that exhausts the pool adds it
again under fresh ids."""

from __future__ import annotations

import time

import numpy as np

JUDGE = "add"


def prepare(run) -> None:
    tp = run.traffic
    n = tp["segment_rows"]
    run.state["pool"] = [run.dep.segment(j, n)
                         for j in range(tp["pool_segments"])]
    warm = run.dep.segment(-1, n)
    run.idx.add_batch_device(warm, np.arange(run.dep.nb, run.dep.nb + n,
                                             dtype=np.int32))
    del warm
    run.state["first_id"] = run.dep.nb + n
    run.sync()


def window(run, seconds: float, tracer) -> dict:
    tp = run.traffic
    n, P = tp["segment_rows"], tp["pool_segments"]
    pool = run.state["pool"]
    nid = run.state["first_id"]
    k = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ids = np.arange(nid + k * n, nid + (k + 1) * n, dtype=np.int32)
        if tracer is not None:
            tracer.before(k)
            with tracer.span(k):
                run.idx.add_batch_device(pool[k % P], ids)
            run.sync()
            tracer.after(k)
        else:
            run.idx.add_batch_device(pool[k % P], ids)
        k += 1
    if tracer is not None:
        tracer.stop()
    tf = time.perf_counter()
    run.idx.finalize()
    run.sync()
    t_end = time.perf_counter()
    run.state["segments"] = k
    return {"e2e": {"add_rows_per_s": k * n / (t_end - t0)},
            "attempted": k * n, "failed": 0,
            "host": {"finalize_s": t_end - tf, "segments": k,
                     "elapsed_s": t_end - t0}}


def added(run, sample_n: int, g):
    """A sample drawn from ``g`` of the rows the window added: (ids [m]
    int64 on the device, pool segment [m], row within it [m])."""
    import torch
    n, P = run.traffic["segment_rows"], run.traffic["pool_segments"]
    total = run.state["segments"] * n
    m = min(sample_n, total)
    pick = torch.randperm(total, generator=g, device=run.device)[:m]
    return run.state["first_id"] + pick, (pick // n) % P, pick % n
