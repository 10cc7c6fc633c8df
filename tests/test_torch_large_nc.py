"""The rest of the port's large-nc surface against the JAX package, on the
CPU: k-means above 8192 centroids, ``inner_product``, the "approx" coarse
mode, the user ``coarse_block`` ceiling, ``scan_slot_demand`` following
``coarse_mode`` and a driver run with ``-coarse_mode routed``.

Tolerances: distances rtol=1e-4, atol=1e-3 (tests/test_pallas_adc.py:
42-46); integer outputs (block sizes, slot demands) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.ops import distances as jd
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.drivers import ivfadc_eval
from ivfhnsw_tpu_torch.ops import distances as td
from ivfhnsw_tpu_torch.ops import kmeans as tk
from ivfhnsw_tpu_torch.ops.routed_coarse import RoutedCoarse

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_kmeans_above_8192_takes_the_hierarchical_seed():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(20000, 4).astype(np.float32))
    cents, mse = tk.kmeans(_gen(0), x, 8200, niter=1)
    assert cents.shape == (8200, 4) and bool(torch.isfinite(cents).all())
    assert 0 < mse < float((x * x).sum(1).mean())
    again, mse2 = tk.kmeans(_gen(0), x, 8200, niter=1)
    assert torch.equal(cents, again) and mse == mse2


def test_inner_product_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(33, 24).astype(np.float32)
    y = rng.randn(50, 24).astype(np.float32)
    ref = np.asarray(jd.inner_product(jnp.asarray(x), jnp.asarray(y),
                                      precision=jax.lax.Precision.HIGHEST))
    out = td.inner_product(torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (33, 50)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nc", [64, 4096, 131072, 1048576])
def test_coarse_block_ceiling_equals_jax(nc):
    cfg = dict(d=8, nc=nc, code_size=4)
    j = JaxIndex(JaxConfig(**cfg))
    t = IVFADCIndex(IndexConfig(**cfg), "cpu")
    for cb in (None, 128, 4096, 16384, 100000, 1 << 21):
        j.coarse_block = t.coarse_block = cb
        assert t._cb() == j._cb()
        for B in (1, 100, 1024, 8192, 65536):
            assert t._coarse_block_for(B) == j._coarse_block_for(B), (cb, B)


def _pair(nc=64, nb=20000, d=32, seed=0):
    """A JAX index with clusters of centroids and the port's index from its
    arrays."""
    rng = np.random.RandomState(seed)
    j = JaxIndex(JaxConfig(d=d, nc=nc, code_size=8))
    groups = rng.randn(8, d).astype(np.float32) * 6.0
    cents = (groups[rng.randint(0, 8, nc)]
             + rng.randn(nc, d).astype(np.float32))
    j.set_centroids(cents)
    base = (cents[rng.randint(0, nc, nb)]
            + rng.randn(nb, d).astype(np.float32) * 0.5)
    j.train_pq(jax.random.PRNGKey(0), base[:4096])
    j.add_batch(base, np.arange(nb, dtype=np.int32))
    j.finalize()
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=d, nc=nc, code_size=8), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, "cpu")
    q = base[rng.randint(0, nb, 48)] + rng.randn(48, d).astype(
        np.float32) * 0.3
    return j, t, q


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("mode", ["exact", "binned", "routed", "auto"])
def test_scan_slot_demand_follows_coarse_mode_as_jax(pair, mode):
    """The demand of the probes each mode selects equals JAX's, routed on
    the same routing state (w=2 of 8 supers: a real cut)."""
    j, t, q = pair
    if mode == "routed":
        j.enable_routed_coarse(w=2, n_super=8, key=jax.random.PRNGKey(4))
        jr = j._routed_coarse
        t._routed_coarse = RoutedCoarse.from_state(
            t.centroids, np.asarray(jr.supers), jr.members, jr.valid)
        t.routed_w = 2
    try:
        for max_codes in (0, 1500):
            kw = dict(k=5, nprobe=6, max_codes=max_codes, coarse_mode=mode)
            jdem = j.scan_slot_demand(q, JaxParams(**kw))
            tdem = t.scan_slot_demand(q, SearchParams(**kw))
            np.testing.assert_array_equal(tdem, jdem)
    finally:
        j._routed_coarse = t._routed_coarse = None
    if mode == "routed":
        exact = t.scan_slot_demand(q, SearchParams(k=5, nprobe=6,
                                                   max_codes=0))
        assert not np.array_equal(tdem, exact)     # the cut shows


def test_driver_runs_routed_on_the_cpu(capsys):
    """ivfadc_eval -coarse_mode routed -device cpu builds the routing
    structure (as JAX's driver does) and searches through it; with w*cap
    covering every centroid the labels are exact coarse's."""
    argv = ["-synthetic", "0", "-device", "cpu", "-d", "32", "-nc", "64",
            "-code_size", "8", "-nb", "6000", "-nt", "3000", "-nq", "100",
            "-nprobe", "8", "-max_codes", "1000", "-k", "10"]
    res = ivfadc_eval.main(argv + ["-coarse_mode", "routed"])
    out = capsys.readouterr().out
    assert "building routed coarse structure" in out
    idx = res["index"]
    assert idx._routed_coarse is not None and idx.routed_w == 16
    assert idx.routed_w * idx._routed_coarse.cap >= 64
    ref = ivfadc_eval.main(argv + ["-coarse_mode", "exact"])
    np.testing.assert_allclose(res["dists"], ref["dists"], rtol=RTOL,
                               atol=ATOL)
    assert res["recalls"] == ref["recalls"]


def test_approx_mode_is_the_bucketed_reduction(pair):
    """"approx" was decided on the card (PERF.md, §7): the faster exact
    reduce took more than a third of the whole search at nc=2^17, so it is
    the bucketed partial reduction of approx_min_k, not an alias of an
    exact one. On the CPU JAX's approx_min_k returns the exact top-k, so
    the port is held to the share its bucket count promises, and to the
    exact results where the buckets hold one lane each."""
    rng = np.random.RandomState(2)
    x = rng.randn(16, 8192).astype(np.float32)
    jv, ji = jax.lax.approx_min_k(jnp.asarray(x), 64, recall_target=0.95)
    exact = np.argsort(x, axis=1, kind="stable")[:, :64]
    np.testing.assert_array_equal(np.sort(np.asarray(ji), 1),
                                  np.sort(exact, 1))      # exact on the CPU
    tv, ti = td.approx_topk_smallest(torch.from_numpy(x), 64, 0.95)
    share = np.mean([np.intersect1d(a, b).size / 64
                     for a, b in zip(ti.numpy(), exact)])
    assert share >= 0.95, share
    assert (np.diff(tv.numpy(), axis=1) >= 0).all()
    np.testing.assert_array_equal(
        tv.numpy(), np.take_along_axis(x, ti.numpy(), 1))
    # the search entry points take it; at coarse_recall 0.999 the 64
    # centroids of this index need more buckets than lanes: exact results
    j, t, q = pair
    kw = dict(k=5, nprobe=6, max_codes=1500)
    t.engine = "fused"
    d0, l0 = t.search(q, SearchParams(**kw, coarse_mode="exact"))
    d1, l1 = t.search(q, SearchParams(**kw, coarse_mode="approx",
                                      coarse_recall=0.999))
    jd0, _ = j.search(q, JaxParams(**kw, coarse_mode="approx"))
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_allclose(d1, np.asarray(jd0), rtol=RTOL, atol=ATOL)
    # and scan_slot_demand profiles the probes approx selects
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tks
    p = SearchParams(**kw, coarse_mode="approx", coarse_recall=0.9)
    probes = tks.select_probes(
        torch.from_numpy(q), t.centroids, t.centroid_norms,
        t.store.list_offsets_t, nprobe=6,
        coarse_block=t._coarse_block_for(len(q)), approx=True,
        recall_target=0.9)[1]
    np.testing.assert_array_equal(t.scan_slot_demand(q, p),
                                  t._slot_demand(probes, p,
                                                 t.scan_gran()).numpy())
