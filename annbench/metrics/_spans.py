"""Helpers of the metrics that read the program's own spans and counters
(``ivfhnsw_tpu_torch/utils/profiling.py``: ``SPANS``, ``COUNTERS``), in
the benchmark's process after the window, against the device stretch
(``ctx.device``: its steps and device operations).

Clock. A span's times are ``time.time_ns()``; a Chrome trace's ``ts`` is
that clock less a constant base, in us. The base comes from the
benchmark's own steps: exactly one program root (``ivf.search`` a call,
``ivf.add`` a segment) opens inside each traced step, a few us after the
step starts. The device stretch is the last one profiled, so its n steps
hold the last n roots recorded. The least (root start - step start) over
the pairs is the base plus those few us; the profiler's base is a whole
second, so the estimate is taken down to one where that moves it by less
than ``SNAP_NS``. Every root then has to lie inside its step, or reading
raises.

Attribution. A device operation goes to the innermost span that was open
on the host when it was launched. An idle gap of the window (as
``Trace.breakdown`` finds them) is split over the innermost spans open on
the host while it lasts, and to ``CALLER`` where no span of the program
was open.
"""

from __future__ import annotations

import bisect

ROOTS = ("ivf.search", "ivf.add")
CALLER = "caller"
SNAP_NS = 1_000_000


def _profiling():
    """The program's profiling module when it records spans, else None."""
    try:
        from ivfhnsw_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "SPANS") else None


def counters() -> dict | None:
    """The program's counters, read once; None for a program without."""
    prof = _profiling()
    return prof.COUNTERS.report() if prof is not None else None


def base_ns(steps: list, roots: list) -> int:
    """The trace's base: ``steps`` [(start, end)] in trace us, ``roots``
    their roots' records, in order."""
    off = min(r.start_ns - round(s0 * 1e3) for (s0, _), r in zip(steps,
                                                                  roots))
    snapped = off - off % 1_000_000_000
    return snapped if off - snapped < SNAP_NS else off


class Spans:
    """The program's spans under the device stretch's roots, on the trace's
    clock: ``spans`` [(start us, end us, name, id, parent)] sorted by
    start, ``roots`` [(start us, end us)] one a step."""

    def __init__(self, trace, records: list):
        steps = trace.steps
        roots = [r for r in records if r.parent is None and r.name in ROOTS]
        if len(roots) < len(steps):
            raise ValueError(f"{len(steps)} traced steps but {len(roots)} "
                             "program roots recorded")
        roots = roots[len(roots) - len(steps):]
        self.base_ns = base_ns(steps, roots)
        us = lambda t: (t - self.base_ns) / 1e3
        self.roots = [(us(r.start_ns), us(r.end_ns)) for r in roots]
        for (s0, s1), (r0, r1) in zip(steps, self.roots):
            if not s0 <= r0 <= r1 <= s1:
                raise ValueError(f"program root [{r0}, {r1}] us lies outside "
                                 f"its step [{s0}, {s1}]")
        keep = {r.id for r in roots}
        self.spans = sorted((us(r.start_ns), us(r.end_ns), r.name, r.id,
                             r.parent) for r in records if r.root in keep)
        self.n_steps = len(steps)
        self._segments = self._timeline()

    def _timeline(self) -> list:
        """[(from, to, name)]: the host's innermost open span, piece by
        piece, ``CALLER`` between roots."""
        bounds = sorted({t for s in self.spans for t in s[:2]})
        out, stack, i = [], [], 0
        for a, b in zip(bounds, bounds[1:]):
            while i < len(self.spans) and self.spans[i][0] <= a:
                stack.append(self.spans[i])
                i += 1
            while stack and stack[-1][1] <= a:
                stack.pop()
            out.append((a, b, stack[-1][2] if stack else CALLER))
        return out

    def innermost(self, times: list) -> list:
        """The innermost span's name at each of ``times`` (trace us; any
        order), None outside every span."""
        starts = [seg[0] for seg in self._segments]
        out = []
        for t in times:
            i = bisect.bisect_right(starts, t) - 1
            name = None
            if i >= 0 and t <= self._segments[i][1]:
                name = self._segments[i][2]
            out.append(None if name == CALLER else name)
        return out

    def op_us(self, trace) -> dict:
        """{span name: device us} of the stretch's step operations by the
        span open at their launch."""
        ops = [op for op in trace.step_ops() if op[3] is not None]
        out = {}
        for op, name in zip(ops, self.innermost([op[3] for op in ops])):
            out[name] = out.get(name, 0.0) + op[2]
        return out

    def idle_us(self, trace) -> dict:
        """{span name or ``CALLER``: us of device idle} over the stretch's
        window, each gap split over the host's spans while it lasts."""
        w = trace.window()
        out = {}
        if w is None:
            return out
        gaps, end = [], w[0]
        for op in sorted((op for op in trace.ops if op[1] + op[2] > w[0]
                          and op[1] < w[1]), key=lambda o: o[1]):
            if op[1] > end:
                gaps.append((end, op[1]))
            end = max(end, op[1] + op[2])
        segs, j = self._segments, 0
        for g0, g1 in gaps:
            t = g0
            while j < len(segs) and segs[j][1] <= t:
                j += 1
            k = j
            while t < g1:
                if k < len(segs) and segs[k][0] <= t:
                    to, name = min(segs[k][1], g1), segs[k][2]
                    k += 1
                else:
                    to = min(segs[k][0], g1) if k < len(segs) else g1
                    name = CALLER
                out[name] = out.get(name, 0.0) + (to - t)
                t = to
        return out


def spans(ctx) -> Spans | None:
    """The program's spans over ``ctx.device`` (computed once a run); None
    when the run was not traced on a card or the program records none."""
    if hasattr(ctx, "_program_spans"):
        return ctx._program_spans
    prof, t = _profiling(), ctx.device
    got = None
    if prof is not None and t is not None and t.n_steps > 0:
        records = prof.SPANS.records()
        if any(r.parent is None and r.name in ROOTS for r in records):
            got = Spans(t, records)
    ctx._program_spans = got
    return got


def span_ms(ctx, name: str):
    """Device ms per step of the operations launched inside span ``name``
    (its own, not its children's); None when nothing ran there."""
    s = spans(ctx)
    if s is None:
        return None
    us = s.op_us(ctx.device).get(name, 0.0)
    return us / s.n_steps / 1e3 if us > 0 else None
