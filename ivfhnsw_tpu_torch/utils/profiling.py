"""Tracing and profiling helpers. Counterpart of
``ivfhnsw_tpu/utils/profiling.py``.

The reference's observability is StopW timers, a dist_calc counter and
compile-time trace macros writing centroid logs (IndexIVF_HNSW.cpp:298-326).
Here:

- :class:`StageTimer`: named stage timing with a report (the same text as
  the JAX package's);
- :func:`device_trace`: a ``torch.profiler`` context writing a Chrome trace
  (viewable in Perfetto or chrome://tracing) into a directory;
- :class:`Counters`: the dist_calc analog, explicit counts (codes scanned,
  lists probed) accumulated by the caller.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{name:28s} {self.totals[name]:9.3f}s  x{self.counts[name]}"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str, device):
    """Profile the enclosed block: host activity always, CUDA activity too
    when ``device`` is a CUDA device. Yields the ``torch.profiler.profile``
    (its ``key_averages()`` sums the events); on exit the trace is written
    to ``logdir/trace.json`` in the Chrome trace format."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class Counters:
    """Accumulating counters (dist_calc analog, hnswalg.h:58)."""

    def __init__(self):
        self.values = defaultdict(int)

    def add(self, name: str, n: int) -> None:
        self.values[name] += int(n)

    def __getitem__(self, name: str) -> int:
        return self.values[name]

    def report(self) -> dict:
        return dict(self.values)
