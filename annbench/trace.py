"""The traced stretches of a run: ``torch.profiler`` over steps of the
window (CPU and CUDA activity; in the layers stretch also the Python
stack), exported as Chrome traces and reduced here to device operations
attributed to layers.

A device operation (kernel, copy, fill) is attributed by where it was
launched: the CUDA runtime call with its correlation id gives the host
time of the launch, and the Python frames open on the host at that time
give the launching code. Of the layers whose frames (``annbench/layers/
*.json``) are open, the one of lowest rank decides; an operation with no
launch record, or a trace without frames, falls back to the layer files'
kernel-name patterns. The benchmark's own span ``annbench.step`` (one per
call or segment) bounds a stretch: operations launched inside a step
count.
"""

from __future__ import annotations

import bisect
import gc
import glob
import json
import os
import re
import tempfile

STEP = "annbench.step"
LAYER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "layers")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120  # a kernel's name in the breakdown, cut to this length
_FRAME = re.compile(r"^(?P<file>.*)\((?P<line>\d+)\): (?P<func>.*)$")


def load_layers(layer_dir: str = LAYER_DIR) -> dict:
    """{stem: layer file dict} of every layer file."""
    out = {}
    for path in sorted(glob.glob(os.path.join(layer_dir, "*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[:-5]] = json.load(f)
    return out


class _Stretch:
    """One stretch of profiling over steps ``first`` .. ``first + n - 1``. It
    starts one step earlier (``lead``), so that its own start-up falls
    outside the counted steps, and Python's garbage collector waits while
    it runs."""

    def __init__(self, first: int, n: int, stack: bool, cuda: bool):
        if first < 1 or n < 1:
            raise ValueError(f"a traced stretch needs first >= 1 and n >= 1,"
                             f" got {first}, {n}")
        self.first, self.last = first, first + n - 1
        self.stack, self.cuda = stack, cuda
        self.prof = None
        self.done = False
        self._events = None

    @property
    def lead(self) -> int:
        return self.first - 1

    def covers(self, step: int) -> bool:
        return self.first <= step <= self.last

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        gc.collect()
        gc.disable()
        self.prof = profile(activities=acts, with_stack=self.stack)
        self.prof.start()

    def stop(self) -> None:
        """Stop profiling and take the events at once (the Chrome trace
        written to a temporary directory, read back and removed), before a
        later stretch can start."""
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self._events = json.load(f)["traceEvents"]
            self.prof = None
            gc.enable()

    def events(self) -> list | None:
        """The stretch's events; None if it never started."""
        self.stop()
        return self._events


class Tracer:
    """The traced stretches of a window, one after the other, from the
    traffic's ``trace_first`` / ``trace_steps`` and ``idle_first`` /
    ``idle_steps``:

    - ``layers``: a short stretch with the Python stack, whose device
      operations are attributed to layers by their launching frames (the
      layers' device time per step, and what they did);
    - ``device``: a longer stretch without the stack, for the device's
      busy and idle share and the breakdown. It spans seconds, so that one
      host stall of some 100 ms moves its idle share by a point or two,
      and the stack's cost per Python call stays out of it.

    A loop calls ``before(step)``, runs the step inside ``span(step)``, and
    calls ``after(step)`` once the step's device work is done."""

    def __init__(self, traffic: dict, cuda: bool):
        self.stretches = {
            "layers": _Stretch(traffic["trace_first"], traffic["trace_steps"],
                               True, cuda),
            "device": _Stretch(traffic["idle_first"], traffic["idle_steps"],
                               False, cuda)}
        a, b = self.stretches["layers"], self.stretches["device"]
        if b.lead <= a.last:
            raise ValueError("the device stretch has to start after the "
                             "layers stretch's last step")

    def covers(self, step: int) -> bool:
        return any(s.covers(step) for s in self.stretches.values())

    def before(self, step: int) -> None:
        for s in self.stretches.values():
            if step == s.lead:
                s.start()

    def span(self, step: int):
        import contextlib

        import torch
        if self.covers(step):
            return torch.profiler.record_function(STEP)
        return contextlib.nullcontext()

    def after(self, step: int) -> None:
        for s in self.stretches.values():
            if step == s.last:
                s.stop()

    def stop(self) -> None:
        for s in self.stretches.values():
            s.stop()

    def traces(self) -> dict:
        """{"layers": Trace or None, "device": Trace or None}."""
        self.stop()
        out = {}
        for name, s in self.stretches.items():
            ev = s.events()
            out[name] = Trace(ev) if ev is not None else None
        return out


def _frame(name: str):
    m = _FRAME.match(name)
    return (m.group("file").replace("\\", "/"), m.group("func")) if m else None


class Trace:
    """Device operations of a traced stretch with their layers."""

    def __init__(self, events: list, layers: dict | None = None):
        self.layers = load_layers() if layers is None else layers
        xs = [e for e in events if e.get("ph") == "X"]
        self.steps = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in xs
                            if e.get("name") == STEP
                            and e.get("cat") == "user_annotation")
        launches = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                launches[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
        ops_by_ext = {e["args"]["External id"]: (e["ts"], e.get("tid"),
                                                 e["name"])
                      for e in xs if e.get("cat") == "cpu_op"
                      and "External id" in e.get("args", {})}
        # [name, ts, dur, launch ts or None, layer, launching host op or None]
        self.ops = []
        tids = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            args = e.get("args", {})
            op = ops_by_ext.get(args.get("External id"))
            launch = launches.get(args.get("correlation"))
            if launch is None and op is not None:
                launch = op[:2]
            t, tid = launch if launch is not None else (None, None)
            self.ops.append([e["name"], e["ts"], e.get("dur", 0), t, None,
                             op[2] if op is not None else None])
            tids.append(tid)
        frames = {}
        for e in xs:
            if e.get("cat") == "python_function":
                f = _frame(e["name"])
                if f is not None:
                    frames.setdefault(e.get("tid"), []).append(
                        (e["ts"], e["ts"] + e.get("dur", 0), f))
        self._attribute(frames, tids)

    def _attribute(self, frames: dict, tids: list) -> None:
        """Each op's layer: of the layers whose frames are open at its
        launch (one sweep per host thread over its nested frames), the one
        of lowest ``rank``; else the first layer whose kernel-name pattern
        matches its name; else "other"."""
        rank = {stem: spec.get("rank", 99) for stem, spec in
                self.layers.items()}
        rules = [(file, func, stem) for stem, spec in self.layers.items()
                 for file, func in spec.get("frames", [])]
        kernels = [(re.compile(pat), stem) for stem, spec in
                   sorted(self.layers.items(), key=lambda kv: rank[kv[0]])
                   for pat in spec.get("kernels", [])]

        def stem_of(frame):
            file, func = frame
            for rf, rfunc, stem in rules:
                if func == rfunc and file.endswith(rf):
                    return stem
            return None

        for tid, fr in frames.items():
            fr = sorted(((s, e, stem_of(f)) for s, e, f in fr),
                        key=lambda x: (x[0], -x[1]))
            queries = sorted((op[3], i) for i, op in enumerate(self.ops)
                             if op[3] is not None and tids[i] == tid)
            stack, fi = [], 0
            for t, i in queries:
                while fi < len(fr) and fr[fi][0] <= t:
                    while stack and stack[-1][1] < fr[fi][0]:
                        stack.pop()
                    stack.append(fr[fi])
                    fi += 1
                while stack and stack[-1][1] < t:
                    stack.pop()
                stems = [st for _, _, st in stack if st]
                self.ops[i][4] = min(stems, key=rank.get) if stems else None
        for op in self.ops:
            if op[4] is None:
                op[4] = next((stem for pat, stem in kernels
                              if pat.search(op[0])), "other")
        starts = [st[0] for st in self.steps]
        self._step_ops = [op for op in self.ops if self._in_steps(op, starts)]

    def _in_steps(self, op, starts) -> bool:
        """Whether ``op`` belongs to a traced step: launched inside one, or,
        with no launch record, started after the first step began."""
        if not self.steps:
            return False
        t = op[3]
        if t is None:
            return op[1] >= self.steps[0][0]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= self.steps[i][1]

    def step_ops(self) -> list:
        return self._step_ops

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def layer_us(self, stem: str) -> float:
        return sum(op[2] for op in self.step_ops() if op[4] == stem)

    def window(self):
        """(start, end) in us: the first step's start to the end of the
        last device operation of the steps."""
        ops = self.step_ops()
        if not ops:
            return None
        return self.steps[0][0], max(op[1] + op[2] for op in ops)

    def busy_us(self) -> float:
        """Time in the window with at least one device operation running."""
        w = self.window()
        if w is None:
            return 0.0
        iv = sorted((max(op[1], w[0]), min(op[1] + op[2], w[1]))
                    for op in self.ops)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def breakdown(self, top: int = 10):
        """The device operations that took most time, by name, and the idle
        gaps of the window by the layer the host was launching into next
        (by the launching host op where no layer is known, as in a trace
        without the Python stack)."""
        by_name = {}
        for op in self.step_ops():
            name = op[0][:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + op[2] * 1e-6
        w = self.window()
        gaps = {}
        if w is not None:
            ops = sorted((op for op in self.ops if op[1] + op[2] > w[0]
                          and op[1] < w[1]), key=lambda o: o[1])
            end = w[0]
            for op in ops:
                if op[1] > end:
                    who = op[5] if op[4] == "other" and op[5] else op[4]
                    key = f"before {who}"
                    gaps[key] = gaps.get(key, 0.0) + (op[1] - end) * 1e-6
                end = max(end, op[1] + op[2])
        rank = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}
