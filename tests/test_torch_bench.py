"""The port's bench tool (ivfhnsw_tpu_torch/tools/bench.py) against the
root bench.py on the same index state, on the CPU: the stage sizes, both
exact-ADC ceilings (recall dicts equal; labels equal to a float64 numpy
brute force but at ties), the C++ baseline (same blob bytes, same R@1),
timed_qps's labels, the recall decomposition, the deep / scale corpus laws
bit for bit; and the d=96 geometry (PQ16, dsub=6): the LUTs against JAX's
build_luts_ext and the ivfadc_eval driver on the CPU.

Tolerances: ceiling distances rtol 1e-4 / atol 1e-3 against float64
(tests/test_pallas_adc.py:42-46), LUTs rtol / atol 1e-5.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu.ops.pallas import adc_scan as pk
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.drivers import ivfadc_eval
from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.tools import bench as tb

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
KS = (1, 10, 100)


def _corpus(seed, nb, d, nq):
    rng = np.random.RandomState(seed)
    centers = rng.randn(40, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, nb)] + rng.randn(nb, d).astype(
        np.float32)
    queries = centers[rng.randint(0, 40, nq)] + rng.randn(nq, d).astype(
        np.float32)
    d2 = ((queries[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    return base, queries, d2.argmin(1)[:, None].astype(np.int64)


def _ivfadc(opq):
    """A JAX IVFADC index (d=32, nc=64, 8-byte codes, 6000 rows, with or
    without OPQ) and the port's carried across from its arrays."""
    base, q, gt = _corpus(9, 6000, 32, 40)
    j = JaxIndex(JaxConfig(d=32, nc=64, code_size=8, do_opq=opq))
    j.set_centroids(base[np.random.RandomState(1).choice(6000, 64, False)])
    j.train_pq(jax.random.PRNGKey(0), base[:3000], pq_niter=5, opq_niter=3)
    j.add_batch(base, np.arange(6000, dtype=np.int32))
    j.finalize()
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=32, nc=64, code_size=8, do_opq=opq),
        np.asarray(j.centroids), np.asarray(j.pq.codebooks),
        np.asarray(j.norm_pq.centroids), st.codes, st.ids, st.norm_codes,
        st.list_offsets, "cpu",
        opq_R=np.asarray(j.opq_R) if opq else None)
    return j, t, q, gt


@pytest.fixture(scope="module")
def plain():
    return _ivfadc(False)


@pytest.fixture(scope="module")
def grouping():
    """A JAX Grouping+OPQ index (d=32, nc=32, nsubc 8) and the port's."""
    base, q, gt = _corpus(31, 6000, 32, 40)
    cfg = dict(d=32, nc=32, code_size=8, nsubc=8, do_opq=True)
    j = JaxGrouping(JaxConfig(**cfg))
    key = jax.random.PRNGKey(0)
    j.train_centroids(key, base[:3000], niter=8)
    j.compute_neighbor_centroids()
    j.train_pq(key, base[:3000], opq_niter=3)
    j.add(base, np.arange(6000, dtype=np.int32))
    j.finalize()
    st = j.store
    t = IVFADCGroupingIndex.from_numpy_state(
        IndexConfig(**cfg), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets,
        np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
        np.asarray(j.inter_centroid_dists), np.asarray(j.opq_R), "cpu")
    return j, t, q, gt


def _decode(j, codes):
    cb = np.asarray(j.pq.codebooks, np.float64)          # [M, 256, dsub]
    dec = np.concatenate([cb[m][codes[:, m]] for m in range(cb.shape[0])],
                         axis=1)
    if j.do_opq:
        dec = dec @ np.asarray(j.opq_R, np.float64)      # R^T applied back
    return dec


def _brute_force(j, q, recon):
    """float64 ADC distances of every query to every stored row, the
    store's ids and the rows in ascending distance (stable)."""
    st = j.store
    ntab = np.asarray(j.norm_pq.centroids, np.float64)[st.norm_codes]
    qd = q.astype(np.float64)
    dist = ((qd * qd).sum(1)[:, None] - 2 * qd @ recon.T + ntab[None])
    return dist, st.ids.astype(np.int64), np.argsort(dist, 1, kind="stable")


def _check_labels(labels, dist, ids, order):
    """Each query's labels are the brute force's top-k but at ties: the
    distances of the returned rows equal the k smallest."""
    row_of = {int(v): i for i, v in enumerate(ids)}
    k = labels.shape[1]
    got = np.take_along_axis(
        dist, np.vectorize(row_of.__getitem__)(labels), 1)
    want = np.take_along_axis(dist, order[:, :k], 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert all(len(set(r)) == k for r in labels.tolist())
    agree = (labels == ids[order[:, :k]]).mean()
    assert agree > 0.95, agree


@pytest.mark.parametrize("smoke", [False, True])
def test_sizes_are_the_jax_bench_sizes(smoke, monkeypatch):
    """Every stage size of the port equals bench.py's constant of the same
    name, at full size and under BENCH_SMOKE=1 (bench.py loaded afresh)."""
    if smoke:
        monkeypatch.setenv("BENCH_SMOKE", "1")
        spec = importlib.util.spec_from_file_location(
            "bench_smoke_sizes", bench.__file__)
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
    else:
        ref = bench
    port = tb.sizes(smoke)
    assert port == {k: getattr(ref, k) for k in port}


@pytest.mark.parametrize("opq", [False, True])
def test_exact_adc_ceiling_matches_jax(opq, plain):
    j, t, q, gt = plain if not opq else _ivfadc(True)
    ceil, labels = tb.exact_adc_ceiling(t, q, gt, ks=KS, blk=1024)
    assert ceil == bench.exact_adc_ceiling(j, q, gt, ks=KS)
    st = j.store
    keys = np.repeat(np.arange(j.nc), np.diff(st.list_offsets))
    recon = _decode(j, st.codes) + np.asarray(j.centroids, np.float64)[keys]
    _check_labels(labels, *_brute_force(j, q, recon))


def test_exact_adc_ceiling_grouping_matches_jax(grouping):
    j, t, q, gt = grouping
    ceil, labels = tb.exact_adc_ceiling_grouping(t, q, gt, ks=KS, blk=1000)
    assert ceil == bench.exact_adc_ceiling_grouping(j, q, gt, ks=KS)
    st = j.store
    lists = np.repeat(np.arange(j.nc * j.nsubc), np.diff(st.list_offsets))
    g, s = lists // j.nsubc, lists % j.nsubc
    c = np.asarray(j.centroids, np.float64)
    nn = c[np.asarray(j.nn_centroid_idxs)[g, s]]
    subc = c[g] + np.asarray(j.alphas, np.float64)[g][:, None] * (nn - c[g])
    _check_labels(labels, *_brute_force(j, q, _decode(j, st.codes) + subc))


def _reference_blob(path, j, q, nprobe, max_codes, k):
    """bench.py:286-300's writer over the JAX index's arrays."""
    st = j.store
    with open(path, "wb") as f:
        np.asarray([0x49564241], "<i4").tofile(f)
        np.asarray([j.d, j.nc, j.code_size, 256, q.shape[0], nprobe,
                    max_codes, k, 80], "<i4").tofile(f)
        np.asarray([st.codes.shape[0]], "<i8").tofile(f)
        np.asarray(j.centroids, "<f4").tofile(f)
        np.asarray(j.pq.codebooks, "<f4").tofile(f)
        np.asarray(j.norm_pq.centroids, "<f4").tofile(f)
        np.asarray(st.codes, "u1").tofile(f)
        np.asarray(st.norm_codes, "u1").tofile(f)
        np.asarray(st.ids, "<i4").tofile(f)
        np.asarray(st.list_offsets, "<i8").tofile(f)
        np.asarray(q, "<f4").tofile(f)


def test_cpu_baseline_matches_jax(plain, tmp_path, monkeypatch):
    """At the BENCH_SMOKE operating point both packages' baselines give
    the same R@1; the port's blob is byte-identical to bench.py's."""
    j, t, q, gt = plain
    S = tb.sizes(True)
    tb.write_baseline_blob(str(tmp_path / "port.blob"), t, q, S["NPROBE"],
                           S["MAX_CODES"], S["K"])
    _reference_blob(str(tmp_path / "ref.blob"), j, q, S["NPROBE"],
                    S["MAX_CODES"], S["K"])
    assert ((tmp_path / "port.blob").read_bytes()
            == (tmp_path / "ref.blob").read_bytes())
    for name in ("SMOKE", "NPROBE", "MAX_CODES", "K"):
        monkeypatch.setattr(bench, name, True if name == "SMOKE"
                            else S[name])
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr(os, "getloadavg", lambda: (0.0, 0.0, 0.0))
    _, r1 = bench.measure_cpu_baseline(j, q, gt)
    got = tb.measure_cpu_baseline(t, q, gt, S, str(tmp_path / "port"),
                                  smoke=True)
    assert got["recall_at_1"] == r1
    assert got["us_per_query"] > 0 and len(got["runs"]) == 1
    assert tb.measure_cpu_baseline(t, q, gt, S, str(tmp_path / "port"),
                                   smoke=True) == got      # cached


def test_timed_qps_labels_are_search_labels(plain):
    _, t, q, _ = plain
    prm = SearchParams(k=10, nprobe=8, max_codes=600)
    qps, labels, single = tb.timed_qps(t, q, prm, runs=1, depth=2)
    assert np.array_equal(labels, t.search(q, prm)[1])
    assert qps > 0 and single > 0


def test_recall_decomposition_matches_jax(plain, tmp_path):
    j, t, q, gt = plain
    engine, j.engine = j.engine, "xla"
    try:
        ref = bench.recall_decomposition(j, q, gt, 8, 300,
                                         str(tmp_path / "jax.json"))
    finally:
        j.engine = engine
    got = tb.recall_decomposition(t, q, gt, 8, 300,
                                  str(tmp_path / "port.json"))
    assert got == ref


@pytest.mark.parametrize("name,d,seed,normalized", [
    ("deep", 96, 21, True), ("scale", 128, 1, False)])
def test_gauss_corpus_law_is_the_jax_bench_law(name, d, seed, normalized):
    """bench.py:879-887 (deep) and :768-772 (scale), recomputed here."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(16384, d).astype(np.float32)
    if normalized:
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    else:
        centers = centers * 4.0
    spectrum = (np.arange(1, d + 1) ** -0.5).astype(np.float32)
    mix = rng.randn(d, d).astype(np.float32) / np.sqrt(d)
    c = tb.GaussCorpus(torch.device("cpu"), d, seed, normalized)
    np.testing.assert_array_equal(c.law["centers"], centers)
    np.testing.assert_array_equal(c.law["spectrum"], spectrum)
    np.testing.assert_array_equal(c.law["mix"], np.float32(mix))
    x = c.gen(5, 300)
    assert x.shape == (300, d) and torch.equal(x, c.gen(5, 300))
    if normalized:
        torch.testing.assert_close(torch.linalg.vector_norm(x, dim=1),
                                   torch.ones(300))


def test_luts_at_dsub6_match_jax():
    """d=96 with PQ16 (dsub=6): the scan tables equal rows 0..15 of JAX's
    build_luts_ext."""
    rng = np.random.RandomState(3)
    q = rng.randn(24, 96).astype(np.float32)
    cb = rng.randn(16, 256, 6).astype(np.float32)
    norm = np.sort(rng.rand(256).astype(np.float32) * 10)
    ref = np.asarray(pk.build_luts_ext(jnp.asarray(q), jnp.asarray(cb),
                                       jnp.asarray(norm),
                                       precision=jax.lax.Precision.HIGHEST))
    got = tk.build_luts(torch.tensor(q), torch.tensor(cb)).numpy()
    assert got.shape == (24, 16, 256)
    np.testing.assert_allclose(got, ref[:, :16], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ref[:, pk.NORM_ROW], np.broadcast_to(
        norm, (24, 256)))


def test_deep1b_geometry_d96(capsys):
    """tests/test_drivers.py::test_deep1b_geometry_d96 for the port: the
    ivfadc_eval driver at d=96, PQ16, on the CPU."""
    res = ivfadc_eval.main(
        "-device cpu -synthetic 0 -d 96 -nc 32 -code_size 16 -nb 4000 "
        "-nt 3000 -nq 50 -k 10 -nprobe 8 -max_codes 1000".split())
    assert res["index"].pq.codebooks.shape == (16, 256, 6)
    assert res["recalls"][10] > 0.3
