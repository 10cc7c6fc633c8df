"""Routed two-level coarse selection of the port (ivfhnsw_tpu_torch.ops.
routed_coarse, IVFADCIndex.enable_routed_coarse / coarse_mode="routed")
against the JAX package's (ivfhnsw_tpu/ops/routed_coarse.py), on the CPU.

The first nine tests are the port's counterparts of
tests/test_routed_coarse.py. Then, from the JAX structure's own arrays
(RoutedCoarse.from_state): the same probes up to f32 ties, qc_dists and
term1 within rtol=1e-4 / atol=1e-3, list sizes and offsets exact; the fused
engine (plain kernels on the CPU) under "routed" against JAX's
pallas_interpret engine under "routed"; the .npz cache read across the
packages; and a list offset above 2^24 kept exact (JAX packs offsets into
f32 channels and refuses them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.ops import routed_coarse as jrc
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.routed_coarse import (RoutedCoarse,
                                                 greedy_partition,
                                                 routed_select_ext)

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _clustered_centroids(nc=512, d=32, n_groups=16, seed=0):
    """Centroid set with clusters of centroids (what routing presumes)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n_groups, d).astype(np.float32) * 8.0
    which = rng.randint(0, n_groups, nc)
    return (g[which] + rng.randn(nc, d).astype(np.float32)).astype(np.float32)


def _offsets(sizes):
    off = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=off[1:])
    return torch.from_numpy(off)


def _sets_equal_up_to_ties(p1, d1, p2, d2):
    """Each query's probe sets agree, or differ only at the boundary
    distance (an f32 tie)."""
    for i in range(p1.shape[0]):
        diff = set(p1[i].tolist()) ^ set(p2[i].tolist())
        if diff:
            kth = d2[i, -1]
            assert abs(d1[i, -1] - kth) <= ATOL + RTOL * abs(kth), i


def test_partition_covers_every_centroid_once():
    cents = _clustered_centroids()
    rc = RoutedCoarse(torch.from_numpy(cents), n_super=16, generator=_gen(1))
    members = rc.members[rc.valid]
    assert members.size == cents.shape[0]
    assert np.array_equal(np.sort(members), np.arange(cents.shape[0]))


def test_partition_capacity_respected():
    cents = torch.from_numpy(_clustered_centroids(nc=256))
    supers = torch.from_numpy(_clustered_centroids(nc=8, seed=3))
    members, valid = greedy_partition(cents, supers, cap=48)
    assert valid.sum(axis=1).max() <= 48
    assert valid.sum() == 256
    with pytest.raises(ValueError):
        greedy_partition(cents, supers, cap=31)


def test_full_w_matches_exact_sweep():
    cents = _clustered_centroids(nc=384, d=16)
    nc = cents.shape[0]
    rng = np.random.RandomState(7)
    sizes = rng.randint(1, 2000, nc)
    rc = RoutedCoarse(torch.from_numpy(cents), n_super=12, generator=_gen(2))
    cn = (cents ** 2).sum(1)
    table = rc.build_table(torch.from_numpy(cn), _offsets(sizes))
    q = torch.from_numpy(rng.randn(24, 16).astype(np.float32))
    nprobe = 10
    d2, probes, term1, sz, lo = routed_select_ext(
        q, rc.supers, rc.super_sqn, table, nprobe=nprobe, w=rc.n_super)
    ed, ei = streaming_topk_l2(q, torch.from_numpy(cents), nprobe,
                               point_sqnorms=torch.from_numpy(cn))
    np.testing.assert_allclose(d2.numpy(), ed.numpy(), rtol=RTOL, atol=ATOL)
    for i in range(q.shape[0]):
        assert set(probes[i].tolist()) == set(ei[i].tolist())
    p = probes.numpy()
    assert probes.dtype == torch.int64
    np.testing.assert_array_equal(sz.numpy(), sizes[p])
    np.testing.assert_array_equal(lo.numpy(), _offsets(sizes).numpy()[p])
    np.testing.assert_allclose(term1.numpy(), d2.numpy() - cn[p], rtol=1e-4,
                               atol=1e-2)


def test_small_w_overlap_on_structured_data():
    cents = _clustered_centroids(nc=512, d=32, n_groups=16)
    rc = RoutedCoarse(torch.from_numpy(cents), n_super=16, generator=_gen(4))
    cn = torch.from_numpy((cents ** 2).sum(1))
    table = rc.build_table(cn, _offsets(np.full(512, 100)))
    rng = np.random.RandomState(11)
    which = rng.randint(0, 512, 64)
    q = torch.from_numpy(cents[which] + rng.randn(64, 32).astype(np.float32)
                         * 0.3)
    _, probes, *_ = routed_select_ext(q, rc.supers, rc.super_sqn, table,
                                      nprobe=8, w=4)
    _, exact = streaming_topk_l2(q, torch.from_numpy(cents), 8,
                                 point_sqnorms=cn)
    pr, ex = probes.numpy(), exact.numpy()
    overlap = np.mean([np.intersect1d(pr[i], ex[i]).size / 8
                       for i in range(64)])
    assert overlap > 0.9


def test_w_cap_must_cover_nprobe():
    cents = _clustered_centroids(nc=128, d=16)
    rc = RoutedCoarse(torch.from_numpy(cents), n_super=8, generator=_gen(5))
    table = rc.build_table(torch.from_numpy((cents ** 2).sum(1)),
                           _offsets(np.ones(128, np.int64)))
    with pytest.raises(ValueError, match="nprobe"):
        routed_select_ext(torch.zeros(4, 16), rc.supers, rc.super_sqn,
                          table, nprobe=rc.cap + 1, w=1)


def _tiny_pair(nc=64, nb=20000, d=32, seed=0):
    """The JAX tests' _tiny_index and the port's index from its arrays."""
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
    t.engine = "fused"
    return j, t, base, rng


@pytest.fixture(scope="module")
def pair():
    return _tiny_pair()


@pytest.fixture(scope="module")
def small_pair():
    return _tiny_pair(nb=5000)


def test_end_to_end_routed_interpret_matches_exact(pair):
    """The fused engine, coarse_mode='routed' with total coverage (w = 64
    >= n_super) equals its exact-coarse results."""
    _, t, base, rng = pair
    q = base[rng.randint(0, base.shape[0], 32)]
    d0, l0 = t.search(q, SearchParams(k=5, nprobe=6, max_codes=3000,
                                      coarse_mode="exact"))
    t.enable_routed_coarse(w=64, n_super=8, generator=_gen(9))
    try:
        d1, l1 = t.search(q, SearchParams(k=5, nprobe=6, max_codes=3000,
                                          coarse_mode="routed"))
    finally:
        t._routed_coarse = None
    np.testing.assert_allclose(d1, d0, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(l1, l0)


def test_routed_requires_structure(small_pair):
    _, t, base, _ = small_pair
    with pytest.raises(ValueError, match="enable_routed_coarse"):
        t.search(base[:4], SearchParams(k=3, nprobe=4, max_codes=0,
                                        coarse_mode="routed"))


def test_auto_mode_ignores_structure_at_small_nc(small_pair):
    """auto keeps the sweep at nc <= 16384 even when a routing structure
    exists."""
    _, t, _, _ = small_pair
    t.enable_routed_coarse(w=2, n_super=8)
    try:
        routed, rw = t._routed_for(SearchParams(coarse_mode="auto"), 6)
        assert routed is None and rw == 0
        routed, rw = t._routed_for(SearchParams(coarse_mode="routed"), 6)
        assert routed is not None and rw == 2
    finally:
        t._routed_coarse = None


def test_from_state_cache_roundtrip(small_pair, tmp_path):
    """enable_routed_coarse(cache_path=...) saves the structure; a reload
    from the cache selects the same probes without k-means or partition."""
    _, t, base, _ = small_pair
    p = str(tmp_path / "routed.npz")
    t.enable_routed_coarse(w=4, n_super=8, cache_path=p)
    sp = SearchParams(k=3, nprobe=6, max_codes=0, coarse_mode="routed")
    try:
        d1, l1 = t.search(base[:16], sp)
        rc1 = t._routed_coarse
        t._routed_coarse = None
        t.enable_routed_coarse(w=4, n_super=8, cache_path=p)
        rc2 = t._routed_coarse
        assert rc2 is not rc1
        np.testing.assert_array_equal(rc2.members, rc1.members)
        np.testing.assert_array_equal(rc2.valid, rc1.valid)
        assert rc2.cap == rc1.cap and rc2.n_super == rc1.n_super
        d2, l2 = t.search(base[:16], sp)
    finally:
        t._routed_coarse = None
    np.testing.assert_array_equal(l2, l1)
    np.testing.assert_allclose(d2, d1)


def _jax_structure(cents, n_super, seed):
    return jrc.RoutedCoarse(cents, n_super=n_super,
                            key=jax.random.PRNGKey(seed))


def _port_from(jax_rc, cents):
    return RoutedCoarse.from_state(torch.from_numpy(np.array(cents)),
                                   np.asarray(jax_rc.supers),
                                   jax_rc.members, jax_rc.valid)


def test_greedy_partition_equals_jax_for_the_same_supers():
    """Same supers in, the same membership out, bit for bit (the spill
    order and the emptiest-super fallback included: cap 24 over 16
    supers leaves 384 slots for 300 centroids, so many spill)."""
    cents = _clustered_centroids(nc=300, d=16, n_groups=5, seed=3)
    supers = _clustered_centroids(nc=16, d=16, n_groups=5, seed=4)
    jm, jv = jrc.greedy_partition(cents, jnp.asarray(supers), cap=24)
    tm, tv = greedy_partition(torch.from_numpy(cents),
                              torch.from_numpy(supers), cap=24)
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(tm[tv], np.asarray(jm)[np.asarray(jv)])
    assert tm.dtype == np.int32


def test_routed_select_ext_on_jax_state_matches_jax():
    cents = _clustered_centroids(nc=512, d=32, n_groups=16, seed=5)
    rng = np.random.RandomState(3)
    sizes = rng.randint(0, 3000, 512).astype(np.int32)
    toffs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    jr = _jax_structure(cents, 16, 6)
    cn = (cents ** 2).sum(1)
    jtab = jr.build_table(cn, sizes, toffs)
    tr = _port_from(jr, cents)
    ttab = tr.build_table(torch.from_numpy(cn), _offsets(sizes))
    q = cents[rng.randint(0, 512, 40)] + rng.randn(40, 32).astype(
        np.float32) * 0.5
    for w in (2, 5):
        jd, jp, jt1, jsz, jtoff = (np.asarray(a) for a in
                                   jrc.routed_select_ext(
                                       jnp.asarray(q), jr.supers,
                                       jr.super_sqn, jtab, nprobe=12, w=w))
        td, tp, tt1, tsz, tlo = (a.numpy() for a in routed_select_ext(
            torch.from_numpy(q), tr.supers, tr.super_sqn, ttab, nprobe=12,
            w=w))
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tt1, jt1, rtol=RTOL, atol=ATOL)
        _sets_equal_up_to_ties(tp, td, jp, jd)
        np.testing.assert_array_equal(tsz, sizes[tp])
        np.testing.assert_array_equal(tlo, toffs[tp])
        same = tp == jp
        np.testing.assert_array_equal(tsz[same], jsz[same].astype(np.int64))
        np.testing.assert_array_equal(tlo[same], jtoff[same].astype(np.int64))


def test_fused_routed_matches_jax_pallas_interpret_routed(small_pair):
    """The same index and routing state in both packages, coarse_mode
    'routed' at w=2 (a real cut): the port's fused engine (plain kernels)
    against JAX's pallas_interpret engine."""
    j, t, base, rng = small_pair
    j.engine = "pallas_interpret"
    j.enable_routed_coarse(w=2, n_super=8, key=jax.random.PRNGKey(3))
    jr = j._routed_coarse
    t._routed_coarse = _port_from(jr, np.asarray(j.centroids))
    t.routed_w = 2
    q = base[rng.randint(0, base.shape[0], 16)] + rng.randn(16, 32).astype(
        np.float32) * 0.2
    try:
        for layout in ("chunk", "quad"):
            j.scan_layout = t.scan_layout = layout
            jd, jl = j.search(q, JaxParams(k=5, nprobe=6, max_codes=800,
                                           coarse_mode="routed"))
            td, tl = t.search(q, SearchParams(k=5, nprobe=6, max_codes=800,
                                              coarse_mode="routed"))
            jd, jl = np.asarray(jd), np.asarray(jl)
            np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
            mism = tl != jl
            assert np.allclose(td[mism], jd[mism], rtol=RTOL, atol=ATOL)
    finally:
        j.engine, j.scan_layout, j._routed_coarse = "auto", "auto", None
        t.scan_layout, t._routed_coarse = "auto", None


def test_npz_cache_reads_across_packages(tmp_path):
    cents = _clustered_centroids(nc=256, d=16, seed=8)
    j = JaxIndex(JaxConfig(d=16, nc=256, code_size=4))
    j.set_centroids(cents)
    t = IVFADCIndex(IndexConfig(d=16, nc=256, code_size=4), "cpu")
    t.set_centroids(cents)
    p_jax, p_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j.enable_routed_coarse(n_super=8, key=jax.random.PRNGKey(1),
                           cache_path=p_jax)
    t.enable_routed_coarse(n_super=8, cache_path=p_jax)       # reads JAX's
    np.testing.assert_array_equal(t._routed_coarse.members,
                                  j._routed_coarse.members)
    np.testing.assert_array_equal(t._routed_coarse.supers.numpy(),
                                  np.asarray(j._routed_coarse.supers))
    t._routed_coarse = None
    t.enable_routed_coarse(n_super=8, generator=_gen(2), cache_path=p_port)
    j._routed_coarse = None
    j.enable_routed_coarse(n_super=8, cache_path=p_port)      # reads ours
    np.testing.assert_array_equal(j._routed_coarse.members,
                                  t._routed_coarse.members)
    np.testing.assert_array_equal(j._routed_coarse.valid,
                                  t._routed_coarse.valid)
    z = np.load(p_port)
    assert sorted(z.files) == ["members", "supers", "valid"]
    assert (z["supers"].dtype, z["members"].dtype, z["valid"].dtype) == (
        np.float32, np.int32, np.bool_)


def test_offsets_above_2_24_stay_exact():
    """List offsets of a store past 2^24 rows (the scale2 store has 134M)
    come back exact: the side table is int64, where JAX's f32 channels
    refuse them."""
    cents = _clustered_centroids(nc=64, d=8, n_groups=4, seed=2)
    sizes = np.full(64, (1 << 24) // 7 + 3, np.int64)
    off = _offsets(sizes)
    assert int(off[-1]) > (1 << 25)
    rc = RoutedCoarse(torch.from_numpy(cents), n_super=4, generator=_gen(0))
    table = rc.build_table(torch.from_numpy((cents ** 2).sum(1)), off)
    q = torch.from_numpy(cents[:5] + 0.01)
    _, probes, _, sz, lo = routed_select_ext(q, rc.supers, rc.super_sqn,
                                             table, nprobe=6, w=4)
    np.testing.assert_array_equal(lo.numpy(), off.numpy()[probes.numpy()])
    np.testing.assert_array_equal(sz.numpy(), sizes[probes.numpy()])
    assert int(lo.max()) > (1 << 24) and lo.dtype == torch.int64
    jr = _jax_structure(cents, 4, 0)
    with pytest.raises(ValueError, match="2\\^24"):
        jr.build_table((cents ** 2).sum(1), sizes,
                       off.numpy()[:-1])
