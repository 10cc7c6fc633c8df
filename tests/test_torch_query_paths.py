"""The PyTorch port's query entry points beside ``search`` against the JAX
package, on the CPU: ``search_device`` (tensors on the device in and out),
``scan_slot_demand`` (profiled slot counts, IVFADC and grouping),
``search_precomputed``, ``search_per_probe`` and ``search_enn``.

Tolerances: distances rtol=1e-4, atol=1e-3 (tests/test_pallas_adc.py:42-46),
labels may differ only where distances tie; slot demands are integers and
bit-equal. JAX leaves the label of a +inf distance undefined in
search_precomputed / search_per_probe, where the port gives -1, so labels
are compared where the distance is finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu_torch import SearchParams
from test_torch_adc_scan import (HIGHEST, RTOL, ATOL, _jax_coarse, _t,
                                 assert_same, built)  # noqa: F401
from test_torch_grouping import _jax_index, carry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gbuilt():
    """A JAX grouping index (tests/test_torch_grouping.py's) and the port's
    carried across."""
    j, _, queries = _jax_index(13, opq=False)
    return j, carry(j), queries


@pytest.mark.parametrize("shape", ["flat", "grouped"])
def test_search_device_matches_jax(built, shape):
    """16 queries as [16, d] or [2, 8, d] tensors: device tensors back, in
    the input's batching, equal to JAX's search_device (interpret mode) and
    to the port's host search."""
    j, t, queries = built
    p = dict(k=10, nprobe=8, max_codes=1000)
    dj, lj = j.search_device(jnp.asarray(queries[:16]), JaxParams(**p),
                             interpret=True)
    dj, lj = np.asarray(dj).reshape(16, -1), np.asarray(lj).reshape(16, -1)
    q = _t(queries[:16])
    if shape == "grouped":
        q = q.reshape(2, 8, -1)
    d, l = t.search_device(q, SearchParams(**p))
    assert isinstance(d, torch.Tensor) and d.device == t.device
    assert d.shape == q.shape[:-1] + (10,) and l.dtype == torch.int64
    assert_same(dj, lj, d.reshape(16, -1).numpy(), l.reshape(16, -1).numpy())
    dh, lh = t.search(queries[:16], SearchParams(**p))
    np.testing.assert_array_equal(d.reshape(16, -1).numpy(), dh)
    np.testing.assert_array_equal(l.reshape(16, -1).numpy(), lh)


def test_search_device_refuses_host_input(built):
    _, t, queries = built
    p = SearchParams(k=5, nprobe=4, max_codes=0)
    with pytest.raises(TypeError):
        t.search_device(queries[:4], p)                 # numpy, not a tensor
    with pytest.raises(ValueError):
        t.search_device(_t(queries[:4]).to("meta"), p)  # another device
    with pytest.raises(ValueError):
        t.search_device(_t(queries[0]), p)              # [d]


def test_grouping_search_device_matches_jax(gbuilt):
    """The grouping index's search_device (with pruning) against JAX's
    engine "xla" on the same index."""
    j, t, queries = gbuilt
    p = dict(k=10, nprobe=8, max_codes=600, do_pruning=True)
    j.engine = "xla"
    try:
        d1, l1 = j.search(queries, JaxParams(**p))
    finally:
        j.engine = "auto"
    d, l = t.search_device(_t(queries).reshape(4, 5, -1), SearchParams(**p))
    assert d.shape == (4, 5, 10)
    assert_same(np.asarray(d1), np.asarray(l1), d.reshape(20, -1).numpy(),
                l.reshape(20, -1).numpy())


def _demands(j, t, queries, layout, p):
    prev = j.scan_layout, t.scan_layout
    j.scan_layout = t.scan_layout = layout
    try:
        return (j.scan_slot_demand(queries, JaxParams(**p)),
                t.scan_slot_demand(queries, SearchParams(**p), batch=7))
    finally:
        j.scan_layout, t.scan_layout = prev


@pytest.mark.parametrize("max_codes", [0, 300])
@pytest.mark.parametrize("layout", ["chunk", "quad"])
def test_scan_slot_demand_bit_equal_ivfadc(built, layout, max_codes):
    j, t, queries = built
    dj, dt = _demands(j, t, queries, layout,
                      dict(k=10, nprobe=12, max_codes=max_codes))
    assert dt.dtype == np.int64 and dt.shape == (len(queries),)
    np.testing.assert_array_equal(dt, dj)
    assert dt.min() > 0


@pytest.mark.parametrize("pruning", [False, True])
@pytest.mark.parametrize("layout", ["chunk", "quad"])
def test_scan_slot_demand_bit_equal_grouping(gbuilt, layout, pruning):
    j, t, queries = gbuilt
    dj, dt = _demands(j, t, queries, layout,
                      dict(k=10, nprobe=8, max_codes=600, do_pruning=pruning))
    np.testing.assert_array_equal(dt, dj)
    assert dt.min() > 0


@pytest.mark.parametrize("index", ["ivfadc", "grouping"])
def test_profiled_budget_keeps_results(built, gbuilt, index):
    """scan_budget = max demand * gran sets the fused engine's slot count to
    the profiled max (never above the worst case) without changing any
    result."""
    _, t, queries = built if index == "ivfadc" else gbuilt
    p = SearchParams(k=10, nprobe=8, max_codes=600,
                     do_pruning=index == "grouping")
    t.engine = "fused"
    dem = t.scan_slot_demand(queries, p)
    capped = SearchParams(k=10, nprobe=8, max_codes=600,
                          do_pruning=p.do_pruning,
                          scan_budget=int(dem.max()) * t.scan_gran())
    assert int(dem.max()) == t._scan_slots(capped, 8) <= t._scan_slots(p, 8)
    d1, l1 = t.search(queries, p)
    d2, l2 = t.search(queries, capped)
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(l2, l1)


@pytest.mark.parametrize("mode", ["approx", "routed"])
def test_scan_slot_demand_refuses_inexact_coarse(built, mode):
    """The demand follows the coarse path of the search under params (the
    JAX rule, ivfhnsw_tpu/models/ivfadc.py:536-570): "routed" without the
    routing structure is refused, as its search is; "approx" profiles the
    probes its search selects (tests/test_torch_large_nc.py holds both
    against JAX's)."""
    _, t, queries = built
    p = SearchParams(k=5, nprobe=8, max_codes=0, coarse_mode=mode)
    if mode == "routed":
        with pytest.raises(ValueError, match="enable_routed_coarse"):
            t.scan_slot_demand(queries, p)
        return
    exact = t.scan_slot_demand(queries, SearchParams(k=5, nprobe=8,
                                                     max_codes=0))
    dem = t.scan_slot_demand(queries, p)
    assert dem.shape == exact.shape and (dem > 0).all()


def _finite_labels_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.isinf(d2), np.isinf(d1))
    fin = np.isfinite(d1)
    mism = (l1 != l2) & fin
    assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)
    assert (l2[~fin] == -1).all()


@pytest.mark.parametrize("max_codes", [0, 300])
def test_search_precomputed_matches_jax(built, max_codes):
    """Caller-given probe lists (JAX's own exact coarse result, so both
    packages scan the same lists)."""
    j, t, queries = built
    qc, probes = _jax_coarse(j, queries, 12)
    p = dict(k=10, nprobe=12, max_codes=max_codes)
    d1, l1 = j.search_precomputed(queries, probes, qc, JaxParams(**p))
    d2, l2 = t.search_precomputed(queries, probes, qc, SearchParams(**p))
    assert d2.shape == (len(queries), 10) and l2.dtype == np.int64
    _finite_labels_same(np.asarray(d1), np.asarray(l1), d2, l2)


@pytest.mark.parametrize("max_codes", [0, 300])
def test_search_per_probe_matches_jax(built, max_codes):
    """One top-k per probe over each whole list; k=300 exceeds every list
    here, so the tails are +inf (label -1 in the port). max_codes is
    ignored, as by the reference."""
    j, t, queries = built
    p = dict(k=300, nprobe=6, max_codes=max_codes)
    d1, l1 = j.search_per_probe(queries, JaxParams(**p))
    d2, l2 = t.search_per_probe(queries, SearchParams(**p))
    assert d2.shape == (len(queries), 6, 300)
    assert np.isinf(d2).any() and np.isfinite(d2).any()
    _finite_labels_same(np.asarray(d1), np.asarray(l1), d2, l2)


def test_search_enn_matches_jax(built):
    j, t, _ = built
    stored = _stored_vectors(j, np.random.RandomState(5), 200)
    d1, l1 = j.search_enn(stored)
    d2, l2 = t.search_enn(stored)
    assert d2.shape == l2.shape == (200,)
    assert_same(np.asarray(d1)[:, None], np.asarray(l1)[:, None],
                d2[:, None], l2[:, None])


def _stored_vectors(j, rng, n):
    """n reconstructions of stored codes (centroid + decoded residual), in
    id order of a random sample: vectors whose nearest code is their own."""
    st = j.store
    rows = np.sort(rng.choice(st.codes.shape[0], n, replace=False))
    keys = np.searchsorted(np.asarray(st.list_offsets), rows, side="right") - 1
    dec = np.asarray(j.pq.decode(jnp.asarray(st.codes[rows])))
    return (np.asarray(j.centroids)[keys] + dec).astype(np.float32)
