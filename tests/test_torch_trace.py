"""search(trace=True), the stats counters and utils/profiling.py of the port
(ivfhnsw_tpu_torch) against the JAX package, on the CPU.

A JAX index of each kind (IVFADC d=32 nc=64, grouping d=32 nc=32 nsubc=8;
code_size 8, 6000 codes, with and without OPQ) is carried into the port with
``from_numpy_state`` and JAX's centroid norms. Both packages search with
``trace=True`` (JAX's portable "xla" engine, the port's torch engine, each
forced by the trace). Tolerances: probes, included and n_scanned equal;
qc_dists and distances within rtol=1e-4, atol=1e-3; labels differ only
where distances tie; the stats counters equal after the same calls.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.utils import profiling as jax_profiling
from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex, IVFADCIndex,
                               SearchParams)
from ivfhnsw_tpu_torch.utils import profiling

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
CFGS = {"ivfadc": dict(d=32, nc=64, code_size=8),
        "grouping": dict(d=32, nc=32, code_size=8, nsubc=8)}


def _corpus(seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(40, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, 6000)] + rng.randn(6000, 32).astype(
        np.float32)
    queries = centers[rng.randint(0, 40, 24)] + rng.randn(24, 32).astype(
        np.float32)
    return base, queries


def _jax_index(kind, opq):
    base, queries = _corpus(21 if opq else 20)
    cfg = JaxConfig(do_opq=opq, **CFGS[kind])
    key = jax.random.PRNGKey(0)
    j = (JaxGrouping if kind == "grouping" else JaxIndex)(cfg)
    j.train_centroids(key, base[:4000], niter=8)
    if kind == "grouping":
        j.compute_neighbor_centroids()
    j.train_pq(key, base[:3000], pq_niter=5, opq_niter=3)
    if kind == "grouping":
        j.add(base, np.arange(len(base), dtype=np.int32))
    else:
        j.add_batch(base, np.arange(len(base), dtype=np.int32))
    j.finalize()
    return j, queries


def _carry(j, kind):
    st = j.store
    common = (IndexConfig(do_opq=j.do_opq, **CFGS[kind]),
              np.asarray(j.centroids), np.asarray(j.pq.codebooks),
              np.asarray(j.norm_pq.centroids), st.codes, st.ids,
              st.norm_codes, st.list_offsets)
    opq_R = np.asarray(j.opq_R) if j.do_opq else None
    if kind == "grouping":
        t = IVFADCGroupingIndex.from_numpy_state(
            *common, np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
            np.asarray(j.inter_centroid_dists), opq_R, "cpu")
    else:
        t = IVFADCIndex.from_numpy_state(*common, "cpu", opq_R=opq_R)
    t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
    return t


@pytest.fixture(scope="module", params=[("ivfadc", False), ("ivfadc", True),
                                        ("grouping", False),
                                        ("grouping", True)],
                ids=["ivfadc-pq", "ivfadc-opq", "grouping-pq",
                     "grouping-opq"])
def built(request):
    kind, opq = request.param
    j, queries = _jax_index(kind, opq)
    return kind, j, _carry(j, kind), queries


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


def _params(kind, max_codes, pruning):
    """Search parameters; IVFADC ignores do_pruning in both packages."""
    return dict(k=10, nprobe=8, max_codes=max_codes, do_pruning=pruning)


@pytest.mark.parametrize("max_codes,pruning", [(0, False), (400, False),
                                               (400, True)],
                         ids=["mc0", "mc400", "mc400-pruned"])
def test_trace_matches_jax(built, max_codes, pruning):
    kind, j, t, queries = built
    p = _params(kind, max_codes, pruning)
    d1, l1, tr1 = j.search(queries, JaxParams(**p), trace=True)
    t.engine = "fused"                      # the trace takes torch anyway
    d2, l2, tr2 = t.search(queries, SearchParams(**p), trace=True)
    assert set(tr2) == {"probes", "qc_dists", "included", "n_scanned"}
    for name in tr1:
        assert tr2[name].dtype == np.asarray(tr1[name]).dtype, name
        assert tr2[name].shape == np.asarray(tr1[name]).shape, name
    for name in ("probes", "included", "n_scanned"):
        np.testing.assert_array_equal(tr2[name], np.asarray(tr1[name]),
                                      err_msg=name)
    np.testing.assert_allclose(tr2["qc_dists"], np.asarray(tr1["qc_dists"]),
                               rtol=RTOL, atol=ATOL)
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)
    if max_codes:
        assert not tr2["included"].all()    # the budget cut some probes


def test_trace_equals_the_untraced_torch_engine(built):
    """The trace changes nothing in the answer: the torch engine's results,
    and n_scanned is what the budget admits (sizes of the included lists,
    unpruned subgroups for grouping)."""
    kind, _, t, queries = built
    p = SearchParams(**_params(kind, 400, kind == "grouping"))
    t.engine = "torch"
    d1, l1 = t.search(queries, p)
    d2, l2, tr = t.search(queries, p, trace=True, batch=7)
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(l2, l1)
    if kind == "ivfadc":
        off = t.store.list_offsets.astype(np.int64)
        sizes = off[tr["probes"] + 1] - off[tr["probes"]]
        np.testing.assert_array_equal(
            tr["n_scanned"], (sizes * tr["included"]).sum(axis=1))
    assert (tr["n_scanned"] > 0).all()


def test_stats_match_jax_after_the_same_calls(built):
    """stats["queries"] counts every search on every engine;
    stats["codes_scanned"] only traced ones, by their n_scanned."""
    kind, j, t, queries = built
    p = _params(kind, 400, False)
    j.stats = {"queries": 0, "codes_scanned": 0}
    t.stats = {"queries": 0, "codes_scanned": 0}
    for trace, n in ((False, 5), (True, 24), (False, 24), (True, 9)):
        j.search(queries[:n], JaxParams(**p), trace=trace)
        t.engine = "fused"
        t.search(queries[:n], SearchParams(**p), trace=trace)
    assert t.stats == j.stats
    assert t.stats["queries"] == 62 and t.stats["codes_scanned"] > 0


def test_search_enn_counts_its_queries(built):
    kind, _, t, _ = built
    t.stats = {"queries": 0, "codes_scanned": 0}
    t.search_enn(np.zeros((3, 32), np.float32))
    assert t.stats == {"queries": 3, "codes_scanned": 0}


def test_trace_rejects_unported_coarse_modes(built):
    """Every coarse mode of the JAX package is ported. A traced search runs
    the torch engine, whose probes are exact whatever coarse_mode says (as
    the JAX portable engine's), so "approx" traces as "exact"; a mode
    outside the known ones is refused."""
    kind, _, t, queries = built
    with pytest.raises(ValueError):
        t.search(queries, SearchParams(coarse_mode="fuzzy"), trace=True)
    d1, l1, tr1 = t.search(queries, SearchParams(coarse_mode="approx"),
                           trace=True)
    d2, l2, tr2 = t.search(queries, SearchParams(coarse_mode="exact"),
                           trace=True)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(tr1["probes"], tr2["probes"])


def test_stage_timer_and_counters_report_as_jax():
    """Counters give JAX's report dict for the same calls. (The port has no
    StageTimer: its stages are ``utils/profiling.py::span``.)"""
    c, d = profiling.Counters(), jax_profiling.Counters()
    for ctr in (c, d):
        ctr.add("codes_scanned", 10)
        ctr.add("codes_scanned", np.int64(5))
        ctr.add("lists", 3)
    assert c.report() == d.report() == {"codes_scanned": 15, "lists": 3}
    assert c["codes_scanned"] == 15 and c["missing"] == 0


def test_device_trace_writes_a_chrome_trace(tmp_path, built):
    kind, _, t, queries = built
    t.engine = "torch"
    with profiling.device_trace(str(tmp_path / "trace"), t.device) as prof:
        t.search(queries, SearchParams(**_params(kind, 400, False)))
    path = tmp_path / "trace" / profiling.TRACE_FILE
    assert os.path.getsize(path) > 0
    import json
    events = json.loads(path.read_text())["traceEvents"]
    assert any("topk" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
