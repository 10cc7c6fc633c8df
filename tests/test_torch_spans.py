"""The port's spans and counters (``utils/profiling.py``: ``span``,
``SPANS``, ``Counters``, ``COUNTERS``) and the benchmark's reader of them
(``annbench/metrics/_spans.py``), on the CPU; jax-free.

Off (no profiler running) a span calls no ``record_function`` and records
nothing, and no counter counts. On, under a CPU ``torch.profiler``, both
indexes emit the span tree of a search on the fused engine and an add, and
the counters hold kept <= rows <= lanes. The reader maps spans onto a
trace's clock from the benchmark's steps, gives each device operation the
span open at its launch and splits idle gaps over the host's spans.
"""

import functools
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from annbench import harness
from annbench.metrics import _spans
from annbench.trace import STEP, Trace
from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex, IVFADCIndex,
                               SearchParams)
from ivfhnsw_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ivfhnsw_tpu_torch")
NEW_METRICS = ("coarse_span_ms.search", "tables_span_ms.search",
               "scan_span_ms.search", "topk_span_ms.search",
               "call_idle_ms.search", "slot_fill_pct.search",
               "assign_span_ms.add", "encode_span_ms.add", "segment_ms.add")
SEARCH_TREE = {"ivf.search": None, "ivf.plan": "ivf.search",
               "ivf.chunk": "ivf.search", "ivf.coarse": "ivf.chunk",
               "ivf.tables": "ivf.chunk", "ivf.scan": "ivf.chunk",
               "ivf.topk": "ivf.chunk", "ivf.count": "ivf.chunk"}
ADD_TREE = {"ivf.add": None, "ivf.assign": "ivf.add",
            "ivf.encode": "ivf.add", "ivf.to_host": "ivf.add"}
FINALIZE_TREE = {"ivf.finalize": None,
                 **{f"ivf.finalize.{s}": "ivf.finalize"
                    for s in ("host", "upload", "sort", "copy_back")}}

torch.set_num_threads(1)


def _corpus():
    rng = np.random.RandomState(5)
    centers = rng.randn(40, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, 6000)] + rng.randn(6000, 32).astype(
        np.float32)
    queries = centers[rng.randint(0, 40, 80)] + rng.randn(80, 32).astype(
        np.float32)
    return base, torch.from_numpy(queries)


@functools.lru_cache(maxsize=None)
def _built(kind):
    """(kind, index, base, queries, params): a small index of ``kind``
    trained and filled on the CPU (grouping with OPQ and pruning)."""
    base, queries = _corpus()
    grouping = kind == "grouping"
    cfg = IndexConfig(d=32, nc=32 if grouping else 64, code_size=8,
                      **(dict(nsubc=8, do_opq=True) if grouping else {}))
    t = (IVFADCGroupingIndex if grouping else IVFADCIndex)(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    t.train_centroids(g, base[:4000], niter=8)
    if grouping:
        t.compute_neighbor_centroids()
    t.train_pq(g, base[:3000], pq_niter=5, opq_niter=2)
    ids = np.arange(len(base), dtype=np.int32)
    if grouping:
        t.alpha_pass(base)
        t.finalize_alphas()
    t.add_batch(base, ids)
    t.finalize()
    if grouping:
        t.compute_inter_centroid_dists()
    params = SearchParams(k=10, nprobe=8, max_codes=1000,
                          do_pruning=grouping)
    return kind, t, base, queries, params


@pytest.fixture(params=["ivfadc", "grouping"])
def built(request):
    return _built(request.param)


@pytest.fixture
def clean():
    profiling.SPANS.clear()
    profiling.COUNTERS.clear()
    yield
    profiling.SPANS.clear()
    profiling.COUNTERS.clear()


def _traced(fn, steps=1):
    """Run ``fn`` ``steps`` times, each inside an ``annbench.step`` span,
    under a CPU profiler; returns the Chrome trace's events."""
    import tempfile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            with torch.profiler.record_function(STEP):
                fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _check_tree(records, tree):
    """Every record is named in ``tree`` under its parent there, its root
    id is its root ancestor's, and every name of ``tree`` occurs."""
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.name in tree, r.name
        parent = by_id[r.parent] if r.parent is not None else None
        assert (parent.name if parent else None) == tree[r.name], r
        top = r
        while top.parent is not None:
            top = by_id[top.parent]
        assert r.root == top.id
        assert r.start_ns <= r.end_ns
        if parent is not None:
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert {r.name for r in records} == set(tree)


def test_off_records_nothing(built, clean, monkeypatch):
    """With no profiler running, a search and an add on the fused engine
    call no record_function and leave SPANS and COUNTERS empty."""
    kind, t, base, queries, params = built

    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.tracing()
    assert profiling.span("ivf.search") is profiling.span("ivf.scan")
    t.engine = "fused"
    d, l = t.search_device(queries, params, batch=32)
    assert l.shape == (queries.shape[0], params.k)
    extra = type(t)(t.config, "cpu")
    extra.set_centroids(t.centroids)
    extra.pq, extra.norm_pq, extra.opq_R = t.pq, t.norm_pq, t.opq_R
    if kind == "grouping":
        extra.nn_centroid_idxs, extra.alphas = t.nn_centroid_idxs, t.alphas
    extra.add_batch_device(torch.from_numpy(base[:300]))
    extra.finalize()
    assert extra.store.ntotal == 300
    assert profiling.SPANS.records() == []
    assert profiling.COUNTERS.report() == {}


@pytest.mark.parametrize("kind,scan_topk", [("ivfadc", "wide"),
                                            ("ivfadc", "twophase"),
                                            ("grouping", "wide")])
def test_search_span_tree_and_counters(clean, kind, scan_topk):
    """A traced search_device on the fused engine records one
    ``ivf.search`` root a call and the stage tree under it, a chunk per
    batch; the counters hold kept <= rows <= lanes (kept == rows without
    pruning), and the wide top-k takes every bin minimum from the scan
    kernel (one a 32 lanes), reducing none itself."""
    kind, t, _, queries, params = _built(kind)
    t.engine, t.scan_topk = "fused", scan_topk
    try:
        _traced(lambda: t.search_device(queries, params, batch=32), steps=2)
    finally:
        t.scan_topk = "auto"
    recs = profiling.SPANS.records()
    _check_tree(recs, SEARCH_TREE)
    names = [r.name for r in recs]
    assert names.count("ivf.search") == 2
    assert names.count("ivf.chunk") == 2 * 3          # 80 queries, 32 a chunk
    assert names.count("ivf.scan") == 6 * (2 if scan_topk == "twophase"
                                           else 1)
    c = profiling.COUNTERS.report()
    wide = scan_topk == "wide"
    assert set(c) == {"scan.lanes", "scan.rows", "scan.kept",
                      *(["topk.bins_kernel"] if wide else [])}
    assert 0 < c["scan.kept"] <= c["scan.rows"] <= c["scan.lanes"]
    if wide:
        assert c["topk.bins_kernel"] * 32 == c["scan.lanes"]
    if kind == "ivfadc":
        assert c["scan.kept"] == c["scan.rows"]
    else:
        assert c["scan.kept"] < c["scan.rows"]         # pruning drops rows


def test_grouping_kept_counts_unpruned_rows(clean):
    """``scan.kept`` of a grouping search equals the unpruned subgroup rows
    of the groups the schedule admits, as ``grouping_scan.scan_inputs``
    computes them (``query_terms``' scan mask over ``sub_sizes``)."""
    _, t, _, queries, params = _built("grouping")
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.grouping import probe_budget, query_terms
    t.engine = "fused"
    q = queries[:32]
    _traced(lambda: t.search_device(q, params, batch=32))
    gv = t._grouped()
    qc, probes = streaming_topk_l2(q, t.centroids, params.nprobe,
                                   block=t._coarse_block_for(32),
                                   point_sqnorms=t.centroid_norms)
    _, _, scan, ssz = query_terms(
        q, qc, probes, t.centroids, t.centroid_norms, t.nn_centroid_idxs,
        t.alphas, t.inter_centroid_dists, gv.sub_sizes_t, params.max_codes,
        True)
    eff = torch.where(scan, ssz, 0).sum(dim=2)
    admitted = probe_budget(eff, params.max_codes) & (eff > 0)
    assert profiling.COUNTERS["scan.kept"] == int(eff[admitted].sum())


def test_grouping_kept_within_a_scan_budget(clean):
    """A scan budget that cuts the schedule short cuts ``scan.kept`` too:
    a probe keeps at most the rows its slots hold, so kept <= rows still
    holds, and fewer rows are kept than without the budget."""
    _, t, _, queries, params = _built("grouping")
    t.engine = "fused"
    q = queries[:32]
    _traced(lambda: t.search_device(q, params, batch=32))
    full = profiling.COUNTERS["scan.kept"]
    profiling.COUNTERS.clear()
    cut = SearchParams(k=params.k, nprobe=params.nprobe,
                       max_codes=params.max_codes, do_pruning=True,
                       scan_budget=t.scan_gran())
    _traced(lambda: t.search_device(q, cut, batch=32))
    c = profiling.COUNTERS.report()
    assert c["scan.lanes"] == 32 * t.scan_gran()
    assert 0 < c["scan.kept"] <= c["scan.rows"] <= c["scan.lanes"]
    assert c["scan.kept"] < full


@pytest.mark.parametrize("case", ["ivfadc", "grouping", "untraced",
                                  "coarse_binned"])
def test_topk_bin_counters(clean, case):
    """``topk.bins_kernel`` and ``topk.bins_reduced``: a traced fused search
    takes all B x nslots x gran / 32 bin minima of its scans from the scan
    kernel and reduces none; an untraced one counts nothing; the coarse
    sweep's binned reduction (no kernel beside it) only reduces, B x
    block / 32 bins a block."""
    kind = "grouping" if case == "grouping" else "ivfadc"
    _, t, _, queries, params = _built(kind)
    t.engine = "fused"
    if case == "coarse_binned":
        from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
        _traced(lambda: streaming_topk_l2(queries, t.centroids, 2, block=32,
                                          exact_reduce="binned"))
        assert profiling.COUNTERS.report() == {
            "topk.bins_reduced": len(queries) * t.nc // 32}
        return
    gran = t.scan_gran()
    inputs = (t.grouping_scan_inputs(queries[:32], params, gran)[6]
              if kind == "grouping" else
              t.scan_inputs(queries[:32], params, gran)[4])
    want = len(queries) * inputs.shape[1] * gran // 32
    search = lambda: t.search_device(queries, params, batch=32)
    if case == "untraced":
        search()
        assert profiling.COUNTERS.report() == {}
        return
    _traced(search)
    c = profiling.COUNTERS.report()
    assert c["topk.bins_kernel"] == want
    assert "topk.bins_reduced" not in c


def test_add_and_finalize_span_trees(clean):
    """add_batch_device is one ``ivf.add`` root a segment (assign, encode,
    the host copies); finalize one ``ivf.finalize`` root with its four
    parts."""
    _, t, base, _, _ = _built("ivfadc")
    extra = IVFADCIndex(t.config, "cpu")
    extra.set_centroids(t.centroids)
    extra.pq, extra.norm_pq = t.pq, t.norm_pq
    segs = iter([base[:400], base[400:900]])
    _traced(lambda: extra.add_batch_device(torch.from_numpy(next(segs))),
            steps=2)
    recs = profiling.SPANS.records()
    _check_tree(recs, ADD_TREE)
    assert [r.name for r in recs].count("ivf.add") == 2
    profiling.SPANS.clear()
    _traced(extra.finalize)
    _check_tree(profiling.SPANS.records(), FINALIZE_TREE)
    assert extra.store.ntotal == 900


@pytest.mark.parametrize("traced_only,pairs", [(False, 1), (True, 1),
                                               (True, profiling.FOLD)])
def test_counters_add_a_device_tensor_without_reading_it(monkeypatch,
                                                          traced_only, pairs):
    """``Counters.add`` of a 0-d tensor reads no value back (no int(), no
    item()), also when a name's tensors are summed into one; ``report``
    reads them; a ``traced_only`` instance counts only under a profiler."""
    c = profiling.Counters(traced_only=traced_only)
    vals = [torch.tensor(5), torch.tensor(7, dtype=torch.int32)] * pairs

    def refuse(*a, **k):
        raise AssertionError("a counter read its tensor")

    for attr in ("__int__", "__index__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        for v in vals:
            c.add("rows", v)
        c.add("lanes", 64)
    c.add("lanes", 36)                        # no profiler running
    monkeypatch.undo()
    held = c.held["rows"]
    assert held and all(isinstance(t, torch.Tensor) for t in held)
    assert len(held) < profiling.FOLD
    assert c.report() == {"rows": 12 * pairs,
                          "lanes": 64 if traced_only else 100}
    assert c["rows"] == 12 * pairs and c["missing"] == 0
    c.clear()
    assert c.report() == {}


def test_span_buffer_is_bounded():
    buf = profiling.SpanBuffer(capacity=3)
    for i in range(5):
        buf.append(profiling.SpanRecord(i, "s", i, i + 1, None, i, 1))
    assert [r.id for r in buf.records()] == [2, 3, 4]
    buf.clear()
    assert buf.records() == []


# ---------------------------------------------------------------------------
# annbench/metrics/_spans.py on a toy trace
# ---------------------------------------------------------------------------

def _rec(i, name, t0, t1, parent, root, base):
    return profiling.SpanRecord(i, name, base + t0 * 1000, base + t1 * 1000,
                                parent, root, 1)


def _toy(base=5_000_000_000):
    """One step [1000, 2000] us of a trace whose base is ``base`` ns: root
    ``ivf.search`` [1003, 1800] with ``ivf.coarse`` [1010, 1100] and
    ``ivf.scan`` [1200, 1300]; kernels launched at 1050 (coarse), 1150 (the
    root itself), 1250 (scan) and a copy launched at 1900 (the caller)."""
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "tid": 1, "args": {"correlation": corr}}

    def op(name, corr, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": 7, "args": {"correlation": corr}}

    ev = [{"ph": "X", "cat": "user_annotation", "name": STEP, "ts": 1000,
           "dur": 1000, "tid": 1},
          launch(1, 1050), op("gemm", 1, 1060, 90),
          launch(2, 1150), op("cat", 2, 1160, 30),
          launch(3, 1250), op("scan_kernel", 3, 1300, 200),
          launch(4, 1900), op("Memcpy DtoH", 4, 1905, 5, "gpu_memcpy")]
    recs = [_rec(1, "ivf.coarse", 1010, 1100, 0, 0, base),
            _rec(2, "ivf.scan", 1200, 1300, 0, 0, base),
            _rec(0, "ivf.search", 1003, 1800, None, 0, base)]
    return Trace(ev, layers={}), recs


@pytest.mark.parametrize("base", [5_000_000_000, 7_000_000_000])
def test_spans_attribute_ops_to_the_span_open_at_launch(base):
    t, recs = _toy(base)
    s = _spans.Spans(t, recs)
    assert s.base_ns == base                  # taken down to the second
    assert s.roots == [(1003.0, 1800.0)]
    assert s.op_us(t) == {"ivf.coarse": 90, "ivf.search": 30, "ivf.scan": 200,
                          None: 5}


def test_spans_split_idle_gaps_and_the_caller_bucket():
    """Gaps 1000-1060, 1150-1160, 1190-1300, 1500-1905 split over the host's
    innermost spans; outside the root they are the caller's."""
    t, recs = _toy()
    idle = _spans.Spans(t, recs).idle_us(t)
    assert idle == pytest.approx({_spans.CALLER: 3 + 105, "ivf.search":
                                  7 + 10 + 10 + 300, "ivf.coarse": 50,
                                  "ivf.scan": 100})
    w = t.window()
    assert sum(idle.values()) == pytest.approx(w[1] - w[0] - t.busy_us())


def test_spans_base_not_a_whole_second_and_a_root_outside_its_step():
    """A base off the second is taken as the least root-to-step distance
    (the root then starts with its step); a root that cannot lie inside
    its step raises, as does a step without a root."""
    t, recs = _toy(5_123_456_789)
    s = _spans.Spans(t, recs)
    assert s.base_ns == 5_123_456_789 + 3000
    assert s.roots == [(1000.0, 1797.0)]
    long_root = recs[:2] + [_rec(0, "ivf.search", 1003, 2100, None, 0,
                                 5_000_000_000)]
    with pytest.raises(ValueError, match="outside its step"):
        _spans.Spans(t, long_root)
    with pytest.raises(ValueError, match="program roots"):
        _spans.Spans(t, recs[:2])


def test_spans_align_with_a_real_cpu_profile(built, clean):
    """On a real CPU profile of two traced calls, each root's
    record_function event, and every ``aten::`` op run inside it, lies
    inside its mapped root; each mapped stage span lies inside its root and
    holds ``aten::`` ops of the trace, so the stages share the trace's
    clock too."""
    kind, t, _, queries, params = built
    t.engine = "fused"
    ev = _traced(lambda: t.search_device(queries, params, batch=32), 2)
    s = _spans.Spans(Trace(ev, layers={}), profiling.SPANS.records())
    xs = [e for e in ev if e.get("ph") == "X"]
    marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("ivf."))
    assert len(marks) == len(s.roots) == 2
    aten = [(e["ts"], e["ts"] + e["dur"]) for e in xs
            if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    for (m0, m1), (a, b) in zip(marks, s.roots):
        assert a <= m0 <= m1 <= b
        inside = [(o0, o1) for o0, o1 in aten if m0 <= o0 and o1 <= m1]
        assert inside and all(a <= o0 and o1 <= b for o0, o1 in inside)
    for a, b, name, *_ in s.spans:
        assert any(r0 <= a <= b <= r1 for r0, r1 in s.roots)
        if name in ("ivf.coarse", "ivf.tables", "ivf.topk"):
            assert any(a <= o0 and o1 <= b for o0, o1 in aten), name


@pytest.mark.parametrize("what", ["ivfadc", "grouping", "add", "finalize"])
def test_only_roots_open_a_record_function(clean, what):
    """Under a profiler the trace holds one ``ivf.*`` annotation a root
    (``ivf.search``, ``ivf.add``, ``ivf.finalize``), of its name and times,
    and none for the stages inside it, whose host cost would leave the
    device idle."""
    kind, t, base, queries, params = _built("grouping" if what == "grouping"
                                            else "ivfadc")
    t.engine = "fused"
    extra = IVFADCIndex(t.config, "cpu")
    extra.set_centroids(t.centroids)
    extra.pq, extra.norm_pq = t.pq, t.norm_pq
    if what == "finalize":
        extra.add_batch_device(torch.from_numpy(base[:400]))
    fn = {"add": lambda: extra.add_batch_device(torch.from_numpy(base[:400])),
          "finalize": extra.finalize}.get(
        what, lambda: t.search_device(queries, params, batch=32))
    ev = _traced(fn, 2 if what != "finalize" else 1)
    marks = sorted((e["ts"], e["name"]) for e in ev if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("ivf."))
    recs = profiling.SPANS.records()
    roots = [r for r in recs if r.parent is None]
    assert len(recs) > len(roots) > 0
    assert [n for _, n in marks] == [r.name for r in roots]
    assert {r.name for r in roots} < set(_spans.ROOTS) | {"ivf.finalize"}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_reads_spans_the_port_has(clean, name):
    """Each new metric is in BENCHMARK.json with its cells, loads, returns
    None on a run without traces, and every span or counter name it reads
    is one the port records."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["workloads"]
    mod = harness.load_metric(name)

    class Ctx:
        device = trace = None

    assert mod.read(Ctx()) is None
    with open(os.path.join(ROOT, "annbench", "metrics", name + ".py")) as f:
        text = f.read()
    wanted = set(re.findall(r'"((?:ivf|scan)\.[a-z_.]+)"', text))
    if name in ("call_idle_ms.search", "segment_ms.add"):
        wanted |= set(_spans.ROOTS)
    assert wanted
    port = ""
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    port += fh.read()
    recorded = set(re.findall(r'span\("([a-z_.]+)"\)', port)) | set(
        re.findall(r'COUNTERS\.add\("([a-z_.]+)"', port))
    assert wanted <= recorded
