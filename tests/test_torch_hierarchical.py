"""The port's two-level assigner (ivfhnsw_tpu_torch.ops.hierarchical,
IVFADCIndex.enable_fast_assign) and hierarchical seeding (ops.kmeans.
hierarchical_seed) against the JAX package's, on the CPU.

The first five tests are the port's counterparts of
tests/test_hierarchical.py. Then: the port's assigner built from the JAX
assigner's own supers and membership (from_state) gives JAX's keys, except
where two centroids are at an f32 near-tie (D3: the packages' matmuls round
differently); the capacity-bounded membership is JAX's for the same supers,
bit for bit; and hierarchical seeding draws data rows, k of them, and seeds
a k-means whose MSE is within 5% of the one JAX's seeds give (D2: the two
packages draw different random numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu.ops import hierarchical as jh
from ivfhnsw_tpu.ops import kmeans as jk
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.ops import kmeans as tk
from ivfhnsw_tpu_torch.ops.distances import assign_top1
from ivfhnsw_tpu_torch.ops.hierarchical import TwoLevelAssigner

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _exact(x, cents):
    return ((x[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)


def test_two_level_assign_accuracy(rng):
    d, nc, n = 32, 512, 20000
    centroids = rng.randn(nc, d).astype(np.float32) * 3
    x = (centroids[rng.randint(0, nc, n)]
         + rng.randn(n, d).astype(np.float32))
    tla = TwoLevelAssigner(torch.from_numpy(centroids), w=8,
                           generator=_gen(0))
    agree = (tla.assign(x) == _exact(x, centroids)).mean()
    assert agree > 0.98, agree


def test_two_level_w_monotone(rng):
    d, nc, n = 16, 256, 5000
    centroids = rng.randn(nc, d).astype(np.float32) * 3
    x = centroids[rng.randint(0, nc, n)] + rng.randn(n, d).astype(np.float32)
    exact = _exact(x, centroids)
    rates = []
    for w in (1, 4, 16):
        tla = TwoLevelAssigner(torch.from_numpy(centroids), w=w,
                               generator=_gen(1))
        rates.append((tla.assign(x) == exact).mean())
    assert rates[-1] >= rates[0] - 1e-9
    assert rates[-1] > 0.99


def test_index_fast_assign_integration(rng):
    base = rng.randn(6000, 16).astype(np.float32)
    idx = IVFADCIndex(IndexConfig(d=16, nc=128, code_size=4), "cpu")
    idx.train_centroids(_gen(0), base[:4000], niter=8)
    exact = idx.assign(base[:2000])
    idx.enable_fast_assign(w=8)
    fast = idx.assign(base[:2000])
    assert (exact == fast).mean() > 0.97
    np.testing.assert_array_equal(
        idx._assign_device_exact(torch.from_numpy(base[:2000])), exact)


def test_assigner_capacity_bound_under_skew():
    """Half the centroids in a tight blob: the membership cap stays at 4x
    the average, and the assigned centroid's distance stays within ~1% of
    the exact nearest."""
    rng = np.random.RandomState(0)
    nc, d = 4096, 32
    blob = rng.randn(nc // 2, d).astype(np.float32) * 0.05
    rest = rng.randn(nc - nc // 2, d).astype(np.float32) * 3
    cents = np.concatenate([blob, rest])
    a = TwoLevelAssigner(torch.from_numpy(cents), w=8, generator=_gen(7))
    assert a.cap <= max(8, -(-4 * nc // a.supers.shape[0]))
    x = rng.randn(4000, d).astype(np.float32) * 2
    approx = a.assign(x)
    de, _ = assign_top1(torch.from_numpy(x), torch.from_numpy(cents))
    da = np.sum((x - cents[approx]) ** 2, axis=1)
    ratio = np.mean(np.sqrt(da) / np.maximum(np.sqrt(de.numpy()), 1e-9))
    assert ratio < 1.01, ratio


def test_add_batch_device_matches_host(rng):
    """The device add path builds the host path's store bit for bit (exact
    assigner and routed assigner alike), and assign_device equals
    assign."""
    base = rng.randn(5000, 16).astype(np.float32)
    cfg = IndexConfig(d=16, nc=64, code_size=4)
    idx1 = IVFADCIndex(cfg, "cpu")
    idx1.train_centroids(_gen(0), base[:3000], niter=8)
    idx1.train_pq(_gen(1), base[:3000], pq_niter=6)
    ids = np.arange(5000, dtype=np.int32)
    for fast in (False, True):
        idx2 = IVFADCIndex(cfg, "cpu")
        idx2.set_centroids(idx1.centroids)
        idx2.pq, idx2.norm_pq = idx1.pq, idx1.norm_pq
        a = IVFADCIndex(cfg, "cpu")
        a.set_centroids(idx1.centroids)
        a.pq, a.norm_pq = idx1.pq, idx1.norm_pq
        if fast:
            for ix in (idx2, a):
                ix.enable_fast_assign(w=4, generator=_gen(2))
        a.add_batch(base, ids)
        a.finalize()
        idx2.add_batch_device(torch.from_numpy(base), ids)
        idx2.finalize()
        np.testing.assert_array_equal(a.store.codes, idx2.store.codes)
        np.testing.assert_array_equal(a.store.ids, idx2.store.ids)
        np.testing.assert_array_equal(a.store.list_offsets,
                                      idx2.store.list_offsets)
    tla = TwoLevelAssigner(idx1.centroids, w=8, generator=_gen(2))
    np.testing.assert_array_equal(tla.assign(base),
                                  tla.assign_device(torch.from_numpy(base)))


def _jax_assigner(cents, w, n_super=None, seed=0):
    return jh.TwoLevelAssigner(cents, n_super=n_super, w=w,
                               key=jax.random.PRNGKey(seed))


@pytest.mark.parametrize("w", [1, 4])
def test_from_state_keys_match_jax(w):
    """The JAX assigner's supers and membership in the port: the same keys
    as JAX's assign, except at shown near-ties (the two candidates'
    distances agree within rtol 1e-5 of the point's distance scale)."""
    rng = np.random.RandomState(5)
    nc, d, n = 1024, 24, 6000
    groups = rng.randn(32, d).astype(np.float32) * 6
    cents = groups[rng.randint(0, 32, nc)] + rng.randn(nc, d).astype(
        np.float32)
    x = cents[rng.randint(0, nc, n)] + rng.randn(n, d).astype(np.float32)
    ja = _jax_assigner(cents, w)
    ta = TwoLevelAssigner.from_state(
        torch.from_numpy(cents), np.asarray(ja.supers),
        np.asarray(ja.members), np.asarray(ja.member_valid), w=w)
    assert (ta.cap, ta.n_super) == (ja.cap, ja.n_super)
    jk_ = ja.assign(x)
    tk_ = ta.assign(x)
    mism = np.nonzero(jk_ != tk_)[0]
    assert mism.size <= n // 1000, mism.size
    for i in mism:   # D3: a near-tie between the two picks
        dj = ((x[i] - cents[jk_[i]]) ** 2).sum()
        dt = ((x[i] - cents[tk_[i]]) ** 2).sum()
        assert abs(dj - dt) <= 1e-5 * (x[i] ** 2).sum() + 1e-4, (i, dj, dt)
    np.testing.assert_array_equal(
        ta.assign_device(torch.from_numpy(x)), tk_)


def test_membership_equals_jax_for_the_same_supers():
    """The capacity-bounded membership (cap 4x the average, spill to the
    next-nearest super with room) from JAX's supers equals JAX's, bit for
    bit."""
    rng = np.random.RandomState(6)
    nc, d = 2048, 16
    groups = rng.randn(8, d).astype(np.float32) * 5
    cents = groups[rng.randint(0, 8, nc)] + rng.randn(nc, d).astype(
        np.float32)
    ja = _jax_assigner(cents, 4, n_super=64, seed=2)
    ta = TwoLevelAssigner.__new__(TwoLevelAssigner)
    ta._init_from(torch.from_numpy(cents),
                  torch.from_numpy(np.array(ja.supers)), None, None, 4)
    jv = np.asarray(ja.member_valid)
    np.testing.assert_array_equal(ta.member_valid.numpy(), jv)
    np.testing.assert_array_equal(ta.members.numpy()[jv],
                                  np.asarray(ja.members)[jv])
    assert ta.cap == ja.cap == 128


def test_hierarchical_seed_draws_k_data_rows():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(30000, 8).astype(np.float32))
    for k in (1000, 9000):
        seeds = tk.hierarchical_seed(_gen(k), x, k)
        assert seeds.shape == (k, 8)
        rows = {tuple(r) for r in x.numpy().tolist()}
        s = [tuple(r) for r in seeds.numpy().tolist()]
        assert len(set(s)) == k and all(r in rows for r in s)


def test_quotas_sum_to_k_within_availability():
    """The largest-remainder quotas (JAX's arithmetic): proportional, never
    above a super's pool count, summing to k whenever the pool holds k."""
    rng = np.random.RandomState(4)
    for k in (7, 1000, 4096):
        counts = rng.randint(0, 400, 64).astype(np.int64)
        counts[:5] = 0
        counts[5] = 3 * k
        q = tk._quotas(counts, k)
        assert q.sum() == k and (q <= counts).all() and (q[:5] == 0).all()
        exact = k * counts / counts.sum()
        assert (np.abs(q - exact) < 1 + (q < exact) * exact).all()
    short = tk._quotas(np.array([3, 2, 0], np.int64), 10)
    assert short.tolist() == [3, 2, 0]        # pool smaller than k


def _lloyd_mse(x, cents, niter):
    """MSE after ``niter`` Lloyd rounds from ``cents`` (the port's Lloyd
    step, the same for both seed sets)."""
    c = cents.clone()
    for _ in range(niter):
        sums, counts, _ = tk._lloyd_pass(x, c, 8192)
        c = tk._update_with_split(sums, counts, c)
    d, _ = assign_top1(x, c)
    return float(d.mean())


def test_hierarchical_seed_kmeans_mse_within_5pct_of_jax():
    """k=4096 (k_sup = 16) on a clustered set: Lloyd from the port's seeds
    ends within 5% of Lloyd from JAX's seeds (D2)."""
    rng = np.random.RandomState(8)
    n, d, k = 40000, 16, 4096
    groups = rng.randn(64, d).astype(np.float32) * 4
    x_np = groups[rng.randint(0, 64, n)] + rng.randn(n, d).astype(np.float32)
    x = torch.from_numpy(x_np)
    js = torch.from_numpy(np.asarray(jk.hierarchical_seed(
        jax.random.PRNGKey(0), x_np, k)))
    ts = tk.hierarchical_seed(_gen(0), x, k)
    for niter in (0, 3):
        jm, tm = _lloyd_mse(x, js, niter), _lloyd_mse(x, ts, niter)
        assert tm <= 1.05 * jm, (niter, tm, jm)
