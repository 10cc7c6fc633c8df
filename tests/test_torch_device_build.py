"""The port's device-resident build (IVFADCIndex.add_batch_device, the
grouping index's assign_batch_device / alpha_pass_device /
add_batch_device) and release_device, against the port's host build and the
JAX package's device build, on the CPU; tests marked ``cuda`` repeat the
build and the release on the card.

Tolerances: none within the port (the device build's store arrays and
alpha sums equal the host build's, a search after release_device equals
the one before). Against JAX (tests/test_hierarchical.py:72-91,
tests/test_grouping.py:269-300), from JAX's centroids, neighbours and
quantizers: codes, ids and offsets equal, alphas within rtol=1e-5 (D3: the
alpha statistics are sums of matmul products), and a norm code may differ
only at a near-tie between two norm centroids (D3: the reconstruction's
norm is summed in another order). The JAX
package is imported inside its fixtures, so the card tests run without it.
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex, IVFADCIndex,
                               SearchParams)

torch.set_num_threads(1)
IVF = dict(d=16, nc=64, code_size=4)
GRP = dict(d=32, nc=32, code_size=8, nsubc=8)


def _corpus(seed, n, d):
    rng = np.random.RandomState(seed)
    centers = rng.randn(40, d).astype(np.float32) * 4
    return centers[rng.randint(0, 40, n)] + rng.randn(n, d).astype(
        np.float32)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_JAX = {}


def _jax_state(kind, opq):
    """A JAX index built on the host and the same corpus again through its
    device build; cached per (kind, OPQ)."""
    if (kind, opq) in _JAX:
        return _JAX[kind, opq]
    import jax
    import jax.numpy as jnp
    from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
    from ivfhnsw_tpu import IVFADCIndex as JaxIndex
    from ivfhnsw_tpu import IndexConfig as JaxConfig
    key = jax.random.PRNGKey(0)
    if kind == "ivfadc":
        base = _corpus(5 + opq, 5000, IVF["d"])
        cfg = JaxConfig(do_opq=opq, **IVF)
        j = JaxIndex(cfg)
        j.train_centroids(key, base[:3000], niter=8)
        j.train_pq(key, base[:3000], pq_niter=6, opq_niter=3)
        dev = JaxIndex(cfg)
        dev.set_centroids(np.asarray(j.centroids))
        dev.pq, dev.norm_pq, dev.opq_R = j.pq, j.norm_pq, j.opq_R
        dev.add_batch_device(jnp.asarray(base),
                             np.arange(len(base), dtype=np.int32))
    else:
        base = _corpus(7 + opq, 6000, GRP["d"])
        cfg = JaxConfig(do_opq=opq, **GRP)
        j = JaxGrouping(cfg)
        j.train_centroids(key, base[:4000], niter=8)
        j.compute_neighbor_centroids()
        j.train_pq(key, base[:3000], opq_niter=3)
        dev = JaxGrouping(cfg)
        dev.set_centroids(np.asarray(j.centroids))
        dev.nn_centroid_idxs = j.nn_centroid_idxs
        dev.inter_centroid_dists = j.inter_centroid_dists
        dev.pq, dev.norm_pq, dev.opq_R = j.pq, j.norm_pq, j.opq_R
        x = jnp.asarray(base)
        keys = dev.assign_batch_device(x)
        dev.alpha_pass_device(x, keys)
        dev.finalize_alphas()
        dev.add_batch_device(x, np.arange(len(base), dtype=np.int32),
                             precomputed_idx=keys)
    dev.finalize()
    _JAX[kind, opq] = j, dev, base
    return _JAX[kind, opq]


def _port(kind, j, device="cpu"):
    """An unbuilt port index with JAX's centroids, [neighbours and sweep
    distances,] quantizers and centroid norms."""
    cfg = IndexConfig(do_opq=j.do_opq, **(GRP if kind == "grouping" else IVF))
    t = (IVFADCGroupingIndex if kind == "grouping" else IVFADCIndex)(cfg,
                                                                      device)
    t.set_centroids(np.asarray(j.centroids))
    t.centroid_norms = torch.tensor(np.array(j.centroid_norms),
                                    device=t.device)
    t.pq.codebooks = t._tensor(np.asarray(j.pq.codebooks))
    t.norm_pq.centroids = t._tensor(np.asarray(j.norm_pq.centroids))
    if j.do_opq:
        t.opq_R = t._tensor(np.asarray(j.opq_R))
    if kind == "grouping":
        t.nn_centroid_idxs = torch.tensor(
            np.asarray(j.nn_centroid_idxs, np.int64), device=t.device)
        t.inter_centroid_dists = t._tensor(np.asarray(j.inter_centroid_dists))
    return t


def _same_store(a, b):
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


def _build(t, x, device_build: bool):
    """The whole corpus through the host or the device entry points, in
    two batches."""
    n = x.shape[0]
    parts = [(0, n // 2), (n // 2, n)]
    if isinstance(t, IVFADCGroupingIndex):
        keys = []
        for lo, hi in parts:
            if device_build:
                keys.append(t.assign_batch_device(x[lo:hi]))
                t.alpha_pass_device(x[lo:hi], keys[-1])
            else:
                keys.append(t.assign(x[lo:hi]))
                t.alpha_pass(x[lo:hi], keys[-1])
        t.finalize_alphas()
        for (lo, hi), k in zip(parts, keys):
            ids = np.arange(lo, hi, dtype=np.int32)
            if device_build:
                t.add_batch_device(x[lo:hi], ids, k)
            else:
                t.add_batch(x[lo:hi], ids, k)
    else:
        for lo, hi in parts:
            ids = np.arange(lo, hi, dtype=np.int32)
            if device_build:
                t.add_batch_device(x[lo:hi], ids)
            else:
                t.add_batch(x[lo:hi], ids)
    t.finalize()
    return t


KINDS = [("ivfadc", False), ("ivfadc", True), ("grouping", False),
         ("grouping", True)]
IDS = ["ivfadc-pq", "ivfadc-opq", "grouping-pq", "grouping-opq"]


@pytest.mark.parametrize("kind,opq", KINDS, ids=IDS)
def test_device_build_equals_the_host_build(kind, opq):
    j, _, base = _jax_state(kind, opq)
    host = _build(_port(kind, j), base, False)
    dev = _build(_port(kind, j), torch.from_numpy(base), True)
    _same_store(dev.store, host.store)
    if kind == "grouping":
        assert torch.equal(dev.alphas, host.alphas)
        np.testing.assert_array_equal(dev._alpha_num, host._alpha_num)
        np.testing.assert_array_equal(dev._alpha_den, host._alpha_den)


def _near_tie_norm_codes(j, store, ref_codes, keys_of_row):
    """Rows whose norm code differs from ``ref_codes``: each must be a
    near-tie between the two norm centroids (D3)."""
    cents = np.asarray(j.norm_pq.centroids, np.float64)
    cb = np.asarray(j.pq.codebooks, np.float64)
    for r in np.nonzero(store.norm_codes != ref_codes)[0]:
        dec = cb[np.arange(cb.shape[0]), store.codes[r]].reshape(-1)
        if j.do_opq:
            dec = dec @ np.asarray(j.opq_R, np.float64)
        rec = dec + keys_of_row(r)
        n = float(rec @ rec)
        assert abs(abs(n - cents[store.norm_codes[r]])
                   - abs(n - cents[ref_codes[r]])) <= 1e-5 * n


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_ivfadc_device_build_matches_jax(opq):
    j, jdev, base = _jax_state("ivfadc", opq)
    t = _build(_port("ivfadc", j), torch.from_numpy(base), True)
    for name in ("codes", "ids", "list_offsets"):
        np.testing.assert_array_equal(getattr(t.store, name),
                                      np.asarray(getattr(jdev.store, name)),
                                      err_msg=name)
    keys = np.repeat(np.arange(IVF["nc"]), np.diff(t.store.list_offsets))
    cents = np.asarray(j.centroids, np.float64)
    _near_tie_norm_codes(j, t.store, np.asarray(jdev.store.norm_codes),
                         lambda r: cents[keys[r]])


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_grouping_device_build_matches_jax(opq):
    j, jdev, base = _jax_state("grouping", opq)
    t = _build(_port("grouping", j), torch.from_numpy(base), True)
    np.testing.assert_allclose(t.alphas.numpy(), np.asarray(jdev.alphas),
                               rtol=1e-5)
    np.testing.assert_array_equal(t.store.list_offsets,
                                  np.asarray(jdev.store.list_offsets))
    np.testing.assert_array_equal(t.store.ids, np.asarray(jdev.store.ids))
    same = (t.store.codes == np.asarray(jdev.store.codes)).all(axis=1)
    assert same.mean() > 0.999, same.mean()


@pytest.mark.parametrize("kind,opq", KINDS, ids=IDS)
def test_release_device_then_search_equals_before(kind, opq):
    j, _, base = _jax_state(kind, opq)
    t = _build(_port(kind, j), torch.from_numpy(base), True)
    if kind == "grouping":
        t.compute_inter_centroid_dists()
    q = base[:40] + 0.25
    p = SearchParams(k=10, nprobe=8, max_codes=500,
                     do_pruning=kind == "grouping")
    for engine, layout in (("torch", "auto"), ("fused", "chunk"),
                           ("fused", "quad")):
        t.engine, t.scan_layout = engine, layout
        d1, l1 = t.search(q, p)
        assert t.store._dev
        t.release_device()
        assert t.store._dev == {} and t.store._grouped is None
        d2, l2 = t.search(q, p)
        np.testing.assert_array_equal(d2, d1)
        np.testing.assert_array_equal(l2, l1)


def test_release_device_before_finalize_is_a_no_op():
    t = IVFADCIndex(IndexConfig(**IVF), "cpu")
    t.release_device()
    assert t.store is None


@pytest.mark.parametrize("kind", ["ivfadc", "grouping"])
def test_device_entry_points_take_tensors_on_the_index_device(kind):
    j, _, base = _jax_state(kind, False)
    t = _port(kind, j)
    with pytest.raises(TypeError):
        t.add_batch_device(base[:10])
    with pytest.raises(TypeError):
        t._assign_device_exact(base[:10])
    # the routed assigner takes the device build too (its parity with JAX:
    # tests/test_torch_hierarchical.py); host arrays stay refused
    t.enable_fast_assign(w=4, n_super=8)
    with pytest.raises(TypeError):
        t.add_batch_device(base[:10])
    if kind == "grouping":
        with pytest.raises(TypeError):
            t.assign_batch_device(base[:10])
        np.testing.assert_array_equal(
            t.assign_batch_device(torch.from_numpy(base[:200])),
            t._fast_assigner.assign(base[:200]))
        t._fast_assigner = None
        with pytest.raises(TypeError):
            t.alpha_pass_device(base[:10], np.zeros(10, np.int32))
        with pytest.raises(RuntimeError):     # alphas not learned yet
            t.add_batch_device(torch.from_numpy(base[:10]))


def _card_index(kind, device):
    """A small port index trained from scratch on ``device``."""
    base = _corpus(11, 6000, 32)
    cfg = IndexConfig(**(GRP if kind == "grouping" else dict(
        d=32, nc=64, code_size=8)))
    t = (IVFADCGroupingIndex if kind == "grouping" else IVFADCIndex)(cfg,
                                                                      device)
    g = torch.Generator(device=device).manual_seed(0)
    t.train_centroids(g, base[:4000], niter=8)
    if kind == "grouping":
        t.compute_neighbor_centroids()
    t.train_pq(g, base[:3000], pq_niter=5)
    return t, base


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivfadc", "grouping"])
def test_device_build_equals_the_host_build_on_the_card(card, kind):
    t, base = _card_index(kind, card)
    fresh = type(t)(t.config, card)
    fresh.set_centroids(t.centroids)
    fresh.pq, fresh.norm_pq, fresh.opq_R = t.pq, t.norm_pq, t.opq_R
    if kind == "grouping":
        fresh.nn_centroid_idxs = t.nn_centroid_idxs
        fresh.inter_centroid_dists = t.inter_centroid_dists
    host = _build(t, base, False)
    dev = _build(fresh, torch.tensor(base, device=card), True)
    _same_store(dev.store, host.store)
    if kind == "grouping":
        assert torch.equal(dev.alphas, host.alphas)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivfadc", "grouping"])
def test_release_device_on_the_card(card, kind):
    t, base = _card_index(kind, card)
    t = _build(t, torch.tensor(base, device=card), True)
    p = SearchParams(k=10, nprobe=8, max_codes=500,
                     do_pruning=kind == "grouping")
    d1, l1 = t.search(base[:64], p)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(card)
    t.release_device()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) < held
    d2, l2 = t.search(base[:64], p)
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(l2, l1)
