"""Tracing and profiling helpers. Counterpart of
``ivfhnsw_tpu/utils/profiling.py``.

The reference's observability is StopW timers, a dist_calc counter and
compile-time trace macros writing centroid logs (IndexIVF_HNSW.cpp:298-326).
Here:

- :func:`span`: a named stage of the program. Tracing is on exactly while
  a torch profiler runs (``torch.autograd._profiler_enabled()``); nothing
  else switches it. Off, a span is one check of that flag and a shared
  no-op context. On, it records (name, start, end, parent, root, thread)
  in :data:`SPANS`, read as :class:`SpanRecord`;
  a root span (one opened inside no other) also opens a
  ``torch.profiler.record_function`` of its name, so each call shows in
  every Chrome trace. The inner spans open none: under a profiler with
  CUDA activity a ``record_function`` around device work cost the host
  0.15-0.25 ms (an H100's host, torch 2.11), ~60 of them a search call
  enough to leave the device idle;
- :class:`Counters`: the dist_calc analog, explicit counts (codes scanned,
  lists probed) accumulated by the caller, host ints or 0-d device tensors
  kept on the device and read at once; :data:`COUNTERS`, the program's,
  counts only while tracing is on;
- :func:`device_trace`: a ``torch.profiler`` context writing a Chrome trace
  (viewable in Perfetto or chrome://tracing) into a directory;
- :func:`marginal_ms`: steady-state milliseconds per launch of a function
  (the JAX rigs' ``tools/perf_probe.py::marginal_ms``).

A span's times come from ``time.time_ns()``, the clock the profiler's
Chrome trace counts from: a trace's ``ts`` is that clock less a constant
base, in microseconds.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch

TRACE_FILE = "trace.json"
SPAN_CAPACITY = 1 << 16   # records kept; the oldest go first
FOLD = 256                # device counts a counter keeps before summing them

tracing = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    """One closed span. ``start_ns`` is read as it opens (before a root's
    ``record_function``) and ``end_ns`` as it closes, so the interval
    holds every launch made inside it. ``parent`` is the id of the
    span it opened in (None for a root); ``root`` the id of its root (its
    own for a root); ``thread`` the opening thread's native id."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    root: int
    thread: int


class SpanBuffer:
    """The spans recorded while tracing was on, in the order they closed;
    past ``capacity`` the oldest are dropped. Spans are kept as plain
    tuples and made :class:`SpanRecord` when read."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._records = deque(maxlen=capacity)
        self.append = self._records.append

    def records(self) -> list:
        return [SpanRecord(*r) for r in self._records]

    def clear(self) -> None:
        self._records.clear()


class _Off:
    """The span of tracing off: its methods are C functions (a bound
    ``str.format`` returns "" whatever it is given, so ``__exit__`` lets
    every exception through), so entering and leaving it runs no Python
    frame."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


SPANS = SpanBuffer()
_ids = itertools.count()
_open = threading.local()     # .stack: the thread's open spans; .thread
_OFF = _Off()


class _Span:
    """An open span. Entering and leaving it runs two Python frames, and
    its record is a plain tuple: under a profiler with CUDA activity a span
    that also built a named tuple through a buffer method and an
    initialiser cost an IVFADC search call 12.5 ms of host, against 2.5 ms
    for two frames (an H100's host, torch 2.11)."""

    __slots__ = ("name", "_rf", "_id", "_parent", "_root", "_t0", "_stack")

    def __enter__(self):
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
            _open.thread = threading.get_native_id()
        self._stack = stack
        self._id = i = next(_ids)
        self._t0 = time.time_ns()
        if stack:
            top = stack[-1]
            self._parent, self._root, self._rf = top._id, top._root, None
        else:
            self._parent, self._root = None, i
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        SPANS.append((self._id, self.name, self._t0, time.time_ns(),
                      self._parent, self._root, _open.thread))
        return False


def span(name: str):
    """A context manager marking a stage of the program named ``name``
    (see the module docstring); a no-op unless tracing is on."""
    if not tracing():
        return _OFF
    s = _new_span(_Span)
    s.name = name
    return s


_new_span = object.__new__


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
    """Accumulating counters (dist_calc analog, hnswalg.h:58). ``add``
    takes a host int or a 0-d integer tensor. A tensor is kept as it is:
    adding it launches nothing and reads nothing back (under a profiler a
    launch costs the host tens of us, so each launch of a count is saved);
    a name's first ``FOLD`` tensors are summed into one on their device.
    :meth:`report` reads every tensor with one synchronisation. With
    ``traced_only`` an ``add`` while tracing is off returns at once."""

    def __init__(self, traced_only: bool = False):
        self.values = defaultdict(int)
        self.held = defaultdict(list)
        self.traced_only = traced_only

    def add(self, name: str, n) -> None:
        if self.traced_only and not tracing():
            return
        if isinstance(n, torch.Tensor):
            held = self.held[name]
            held.append(n)
            if len(held) >= FOLD:
                held[:] = [_total(held)]
        else:
            self.values[name] += int(n)

    def __getitem__(self, name: str) -> int:
        return self.report().get(name, 0)

    def report(self) -> dict:
        out = dict(self.values)
        if self.held:
            names = list(self.held)
            dev = self.held[names[0]][0].device
            sums = torch.stack([_total(self.held[k]).to(dev)
                                for k in names]).tolist()
            for k, v in zip(names, sums):
                out[k] = out.get(k, 0) + v
        return out

    def clear(self) -> None:
        self.values.clear()
        self.held.clear()


def _total(tensors: list) -> torch.Tensor:
    """The int64 sum of 0-d tensors on one device, on that device."""
    return torch.stack([t.reshape(()).to(torch.int64)
                        for t in tensors]).sum()


COUNTERS = Counters(traced_only=True)


def marginal_ms(fn, *args, repeat: int = 5) -> float:
    """Steady-state milliseconds per call of ``fn(*args)``: (t_R - t_1) /
    (R - 1), t_r the best of two bundles of r calls enqueued back to back
    and synchronised once (R = ``repeat``), after one warm-up bundle; the
    launch and synchronisation costs cancel. Host clock; on a CUDA device
    the synchronisation is ``torch.cuda.synchronize``."""
    def bundle(r: int) -> float:
        t = time.perf_counter()
        for _ in range(r):
            fn(*args)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return time.perf_counter() - t

    bundle(1)
    t1 = min(bundle(1) for _ in range(2))
    t_r = min(bundle(repeat) for _ in range(2))
    return (t_r - t1) / (repeat - 1) * 1e3
