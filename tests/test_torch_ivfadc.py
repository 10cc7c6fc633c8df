"""The PyTorch port's IVFADC slice (ivfhnsw_tpu_torch.models.ivfadc and its
driver) against the JAX package, on the CPU.

A JAX index is built and carried across with ``from_numpy_state``; the
port's ``search`` (engines "torch" and "fused", both slot widths) must
match JAX's "xla" and "pallas_interpret" (chunk and quad) engines within
the cross-engine contract of tests/test_pallas_adc.py:42-46 (rtol=1e-4,
atol=1e-3; labels may differ only where distances tie), without and with
OPQ. The port's own build from JAX's quantizers must give bit-equal store
arrays (under OPQ a norm code may differ only where the reconstruction's
norm is a near-tie between two norm centroids, which the test shows).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.drivers import ivfadc_eval

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(d=32, nc=64, code_size=8)
PARAMS = [dict(k=10, nprobe=8, max_codes=0),
          dict(k=10, nprobe=16, max_codes=300)]


@pytest.fixture(scope="module")
def built():
    rng = np.random.RandomState(9)
    nb, d = 9000, 32
    centers = rng.randn(48, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, nb)] + rng.randn(nb, d).astype(
        np.float32)
    queries = centers[rng.randint(0, 48, 24)] + rng.randn(24, d).astype(
        np.float32)
    j = JaxIndex(JaxConfig(**CFG))
    j.set_centroids(base[rng.choice(nb, 64, replace=False)])
    j.train_pq(jax.random.PRNGKey(0), base[:4000], pq_niter=5)
    j.add_batch(base, np.arange(nb, dtype=np.int32))
    j.finalize()
    return j, base, queries


def _carry(j, device="cpu"):
    st = j.store
    return IVFADCIndex.from_numpy_state(
        IndexConfig(**CFG), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, device)


@pytest.fixture(scope="module")
def jax_search(built):
    """JAX search results, computed once per (engine, layout, params)."""
    j, _, queries = built
    cache = {}

    def get(engine, layout, p):
        key = (engine, layout, tuple(sorted(p.items())))
        if key not in cache:
            j.engine, j.scan_layout = engine, layout
            try:
                cache[key] = j.search(queries, JaxParams(**p))
            finally:
                j.engine, j.scan_layout = "auto", "auto"
        return cache[key]
    return get


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", PARAMS, ids=["mc0", "mc300"])
@pytest.mark.parametrize("port", [("torch", "auto"), ("fused", "chunk"),
                                  ("fused", "quad")],
                         ids=lambda x: "-".join(x))
@pytest.mark.parametrize("ref", [("xla", "auto"),
                                 ("pallas_interpret", "chunk"),
                                 ("pallas_interpret", "quad")],
                         ids=lambda x: "-".join(x))
def test_search_matches_jax(built, jax_search, p, port, ref):
    j, _, queries = built
    t = _carry(j)
    t.engine, t.scan_layout = port
    d2, l2 = t.search(queries, SearchParams(**p))
    d1, l1 = jax_search(*ref, p)
    assert d2.shape == (len(queries), 10) and l2.dtype == np.int64
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)


@pytest.fixture(scope="module")
def built_opq(built):
    """A JAX IVFADC index with OPQ over the same corpus."""
    _, base, queries = built
    j = JaxIndex(JaxConfig(do_opq=True, **CFG))
    j.set_centroids(np.asarray(built[0].centroids))
    j.train_pq(jax.random.PRNGKey(1), base[:4000], pq_niter=5, opq_niter=3)
    j.add_batch(base, np.arange(len(base), dtype=np.int32))
    j.finalize()
    return j, base, queries


@pytest.mark.parametrize("port", [("torch", "auto"), ("fused", "chunk"),
                                  ("fused", "quad")],
                         ids=lambda x: "-".join(x))
def test_search_opq_matches_jax(built_opq, port):
    """OPQ rotation carried across: LUTs from the rotated queries in both
    engines, coarse selection in the original space."""
    j, _, queries = built_opq
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(do_opq=True, **CFG), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, "cpu",
        opq_R=np.asarray(j.opq_R))
    t.engine, t.scan_layout = port
    p = PARAMS[1]
    j.engine = "xla"
    try:
        d1, l1 = j.search(queries, JaxParams(**p))
    finally:
        j.engine = "auto"
    d2, l2 = t.search(queries, SearchParams(**p))
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)


def test_own_opq_build_bit_equal_store(built_opq):
    """add_batch under OPQ (rotate, encode, unrotate, norm code) from JAX's
    rotation and quantizers reproduces JAX's store bit for bit."""
    j, base, _ = built_opq
    t = IVFADCIndex(IndexConfig(do_opq=True, **CFG), "cpu")
    t.set_centroids(np.asarray(j.centroids))
    t.opq_R = torch.tensor(np.asarray(j.opq_R))
    t.pq.codebooks = torch.tensor(np.asarray(j.pq.codebooks))
    t.norm_pq.centroids = torch.tensor(np.asarray(j.norm_pq.centroids))
    t.add_batch(base, np.arange(len(base), dtype=np.int32))
    t.finalize()
    for name in ("codes", "ids", "list_offsets"):
        np.testing.assert_array_equal(getattr(t.store, name),
                                      getattr(j.store, name), err_msg=name)
    # The unrotation is a matmul that rounds differently in the two
    # packages: a norm code may differ only where the reconstruction's norm
    # (float64) is a near-tie between the two norm centroids.
    tn, jn = t.store.norm_codes, np.asarray(j.store.norm_codes)
    cents = np.asarray(j.norm_pq.centroids, np.float64)
    st = j.store
    keys = np.repeat(np.arange(CFG["nc"]), np.diff(st.list_offsets))
    cb = np.asarray(j.pq.codebooks, np.float64)
    for r in np.nonzero(tn != jn)[0]:
        dec = cb[np.arange(cb.shape[0]), st.codes[r]].reshape(-1)
        rec = dec @ np.asarray(j.opq_R, np.float64) + np.asarray(
            j.centroids, np.float64)[keys[r]]
        n = float(rec @ rec)
        assert abs(abs(n - cents[tn[r]]) - abs(n - cents[jn[r]])) <= 1e-5 * n


def test_search_batches_and_auto_engine(built, jax_search):
    """Several query batches and engine "auto" (= fused) give the one-batch
    result."""
    j, _, queries = built
    t = _carry(j)
    assert t._resolve_engine() == "fused"
    assert t._resolve_layout() == "chunk"       # ~140 codes per list
    d1, l1 = jax_search("xla", "auto", PARAMS[1])
    d2, l2 = t.search(queries, SearchParams(**PARAMS[1]), batch=5)
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)


def test_own_build_bit_equal_store(built):
    """The port's assign + add_batch + finalize, given JAX's centroids and
    quantizers, reproduces JAX's store arrays bit for bit."""
    j, base, _ = built
    t = IVFADCIndex(IndexConfig(**CFG), "cpu")
    t.set_centroids(np.asarray(j.centroids))
    t.pq.codebooks = torch.tensor(np.asarray(j.pq.codebooks))
    t.norm_pq.centroids = torch.tensor(np.asarray(j.norm_pq.centroids))
    np.testing.assert_array_equal(t.assign(base), j.assign(base))
    half = len(base) // 2
    t.add_batch(base[:half], np.arange(half, dtype=np.int32))
    t.add_batch(base[half:])                    # ids continue from ntotal
    t.finalize()
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(getattr(t.store, name),
                                      getattr(j.store, name), err_msg=name)


def test_from_numpy_state_keeps_store_on_add(built):
    """Carried state seeds the builder: a later add + finalize extends the
    store instead of replacing it."""
    j, base, _ = built
    t = _carry(j)
    n0 = t.store.ntotal
    t.add_batch(base[:10], np.arange(n0, n0 + 10, dtype=np.int32))
    t.finalize()
    assert t.store.ntotal == n0 + 10
    assert t.store.list_offsets[-1] == n0 + 10


def test_port_trained_index_quality(built):
    """The port's own training (k-means, PQ, norm-PQ) on the CPU: the fused
    and torch engines agree, and recall against exact search is close to the
    JAX-trained index's."""
    j, base, queries = built
    gen = torch.Generator().manual_seed(0)
    t = IVFADCIndex(IndexConfig(**CFG), "cpu")
    t.train_centroids(gen, base[:4000], niter=8)
    t.train_pq(gen, base[:4000], pq_niter=5)
    t.add_batch(base)
    t.finalize()
    kw = dict(k=10, nprobe=16, max_codes=0)
    p = SearchParams(**kw)
    t.engine = "torch"
    d1, l1 = t.search(queries, p)
    t.engine = "fused"
    d2, l2 = t.search(queries, p)
    assert_same(d1, l1, d2, l2)
    gt = ((queries[:, None, :] - base[None]) ** 2).sum(-1).argmin(1)
    j.engine = "xla"
    _, lj = j.search(queries, JaxParams(**kw))
    j.engine = "auto"
    r_port = (l2 == gt[:, None]).any(1).mean()
    r_jax = (np.asarray(lj) == gt[:, None]).any(1).mean()
    assert r_port >= r_jax - 0.15, (r_port, r_jax)


@pytest.mark.parametrize("bad", ["engine", "layout", "coarse", "opq"])
def test_unported_options_raise(built, bad):
    j, _, queries = built
    if bad == "opq":
        # OPQ itself is ported; its rotation's file format is not, and an
        # OPQ index without a trained rotation refuses to encode.
        with pytest.raises(NotImplementedError):
            ivfadc_eval.main(["-synthetic", "0", "-device", "cpu",
                              "-do_opq", "on", "-path_opq_matrix", "x.opq"])
        t = IVFADCIndex(IndexConfig(do_opq=True, **CFG), "cpu")
        t.set_centroids(np.asarray(j.centroids))
        with pytest.raises(RuntimeError):
            t.add_batch(queries)
        return
    t = _carry(j)
    p = SearchParams(k=5, nprobe=4, max_codes=0)
    if bad == "engine":
        t.engine = "pallas"
    elif bad == "layout":
        t.scan_layout = "tiles"
    else:
        p.coarse_mode = "approx"
    with pytest.raises((ValueError, NotImplementedError)):
        t.search(queries, p)


def test_driver_cpu_runs_and_prints_recall():
    out = subprocess.run(
        [sys.executable, "-m", "ivfhnsw_tpu_torch.drivers.ivfadc_eval",
         "-synthetic", "0", "-device", "cpu", "-d", "32", "-nc", "64",
         "-code_size", "8", "-nb", "20000", "-nt", "5000", "-nq", "200",
         "-nprobe", "8", "-max_codes", "1000", "-k", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    r1 = [ln for ln in out.stdout.splitlines() if ln.startswith("Recall@1:")]
    assert r1 and 0.0 < float(r1[0].split()[1]) <= 1.0, out.stdout
    assert "Time per query" in out.stdout


@pytest.mark.parametrize("argv", [
    ["-synthetic", "0"],                                   # no -device
    ["-device", "cpu"],                                    # no -synthetic
    ["-synthetic", "0", "-device", "cpu", "-path_pq", "x.pq"],
])
def test_driver_refuses_unported_flags(argv):
    with pytest.raises((ValueError, NotImplementedError)):
        ivfadc_eval.main(argv)


def test_import_leaves_jax_out():
    code = ("import sys, ivfhnsw_tpu_torch, ivfhnsw_tpu_torch.drivers."
            "ivfadc_eval, ivfhnsw_tpu_torch.drivers.grouping_eval, "
            "ivfhnsw_tpu_torch.ops.cuda.build, ivfhnsw_tpu_torch.ops.opq; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'ivfhnsw_tpu' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
