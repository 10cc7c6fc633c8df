"""Parity of the port's Grouping ``.index`` file (ivfhnsw_tpu_torch.models.
grouping.IVFADCGroupingIndex.write / read / dump_inter_centroid_dists) with
the JAX package's, on the CPU.

A JAX grouping index (d=32, nc=32, nsubc=8, code_size=8, 8000 codes, with
and without OPQ) is carried into the port with ``from_numpy_state``.
Tolerances: none for files (the two ``write``s give equal bytes, a read
index rewrites its file byte for byte, arrays read back are equal); a
search of the other package's file is held to the cross-engine contract
(rtol=1e-4, atol=1e-3, labels differ only where distances tie), JAX on
engine "xla" and the port on engine "torch".
"""

import jax
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu_torch import IndexConfig, IVFADCGroupingIndex, SearchParams

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
CFG = dict(d=32, nc=32, code_size=8, nsubc=8)
PARAMS = dict(k=10, nprobe=8, max_codes=600, do_pruning=True)


def _jax_index(seed, opq):
    rng = np.random.RandomState(seed)
    nb, d = 8000, 32
    centers = rng.randn(40, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, nb)] + rng.randn(nb, d).astype(
        np.float32)
    queries = centers[rng.randint(0, 40, 20)] + rng.randn(20, d).astype(
        np.float32)
    j = JaxGrouping(JaxConfig(do_opq=opq, **CFG))
    key = jax.random.PRNGKey(0)
    j.train_centroids(key, base[:4000], niter=10)
    j.compute_neighbor_centroids()
    j.train_pq(key, base[:3000], opq_niter=5)
    j.add(base, np.arange(nb, dtype=np.int32) * 2 + 5)
    j.finalize()
    return j, base, queries


def _carry(j):
    """The port's index from JAX's arrays, with JAX's centroid norms (the
    packages sum ||c||^2 in different orders, and the file holds them)."""
    st = j.store
    t = IVFADCGroupingIndex.from_numpy_state(
        IndexConfig(do_opq=j.do_opq, **CFG), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets,
        np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
        np.asarray(j.inter_centroid_dists),
        np.asarray(j.opq_R) if j.do_opq else None, "cpu")
    t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
    return t


@pytest.fixture(scope="module", params=[False, True], ids=["pq", "opq"])
def built(request):
    j, base, queries = _jax_index(17 if request.param else 13, request.param)
    return j, _carry(j), base, queries


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_store(a, b):
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


def _fresh_port(t):
    """An unbuilt port index with t's centroids and quantizers."""
    r = IVFADCGroupingIndex(IndexConfig(do_opq=t.do_opq, **CFG), "cpu")
    r.set_centroids(t.centroids)
    r.pq, r.norm_pq, r.opq_R = t.pq, t.norm_pq, t.opq_R
    return r


def _fresh_jax(j):
    r = JaxGrouping(JaxConfig(do_opq=j.do_opq, **CFG))
    r.set_centroids(np.asarray(j.centroids))
    r.pq, r.norm_pq, r.opq_R = j.pq, j.norm_pq, j.opq_R
    return r


def test_index_file_bytes_identical(built, tmp_path):
    j, t, _, _ = built
    j.write(str(tmp_path / "j.index"))
    t.write(str(tmp_path / "t.index"))
    raw = _bytes(tmp_path / "t.index")
    assert raw == _bytes(tmp_path / "j.index")
    assert np.frombuffer(raw[:24], "<u8").tolist() == [32, 32, 8]


def test_port_reads_jax_file_and_searches_it(built, tmp_path):
    j, t, _, queries = built
    path = str(tmp_path / "j.index")
    j.write(path)
    r = _fresh_port(t)
    r.read(path)
    _same_store(r.store, j.store)
    np.testing.assert_array_equal(r.nn_centroid_idxs.numpy(),
                                  np.asarray(j.nn_centroid_idxs))
    assert r.nn_centroid_idxs.dtype == torch.int64
    np.testing.assert_array_equal(r.alphas.numpy(), np.asarray(j.alphas))
    np.testing.assert_array_equal(r.inter_centroid_dists.numpy(),
                                  np.asarray(j.inter_centroid_dists))
    np.testing.assert_array_equal(r.centroid_norms.numpy(),
                                  np.asarray(j.centroid_norms))
    j.engine = "xla"
    try:
        d1, l1 = j.search(queries, JaxParams(**PARAMS))
    finally:
        j.engine = "auto"
    r.engine = "torch"
    d2, l2 = r.search(queries, SearchParams(**PARAMS))
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)


def test_jax_reads_port_file_and_searches_it(built, tmp_path):
    j, t, _, queries = built
    path = str(tmp_path / "t.index")
    t.write(path)
    r = _fresh_jax(j)
    r.read(path)
    _same_store(r.store, t.store)
    np.testing.assert_array_equal(np.asarray(r.nn_centroid_idxs),
                                  t.nn_centroid_idxs.numpy())
    np.testing.assert_array_equal(np.asarray(r.alphas), t.alphas.numpy())
    np.testing.assert_array_equal(np.asarray(r.inter_centroid_dists),
                                  t.inter_centroid_dists.numpy())
    t.engine = "torch"
    d1, l1 = t.search(queries, SearchParams(**PARAMS))
    t.engine = "auto"
    r.engine = "xla"
    d2, l2 = r.search(queries, JaxParams(**PARAMS))
    assert_same(d1, l1, np.asarray(d2), np.asarray(l2))


def test_read_index_rewrites_its_file_and_searches_equal(built, tmp_path):
    _, t, _, queries = built
    a, b = str(tmp_path / "a.index"), str(tmp_path / "b.index")
    t.write(a)
    r = _fresh_port(t)
    r.read(a)
    r.write(b)
    assert _bytes(a) == _bytes(b)
    for engine, layout in (("torch", "auto"), ("fused", "chunk"),
                           ("fused", "quad")):
        t.engine = r.engine = engine
        t.scan_layout = r.scan_layout = layout
        d1, l1 = t.search(queries, SearchParams(**PARAMS))
        d2, l2 = r.search(queries, SearchParams(**PARAMS))
        np.testing.assert_array_equal(d2, d1)
        np.testing.assert_array_equal(l2, l1)
    t.engine = t.scan_layout = "auto"


def test_append_mode_writes_after_what_the_file_holds(built, tmp_path):
    j, t, _, _ = built
    pj, pt = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    for p in (pj, pt):
        with open(p, "wb") as f:
            f.write(b"head")
    j.write(pj, do_trunc=False)
    t.write(pt, do_trunc=False)
    raw = _bytes(pt)
    assert raw[:4] == b"head" and raw == _bytes(pj)


@pytest.mark.parametrize("cfg", [dict(d=16, nc=32, nsubc=8),
                                 dict(d=32, nc=16, nsubc=8),
                                 dict(d=32, nc=32, nsubc=4)],
                         ids=["d", "nc", "nsubc"])
def test_read_rejects_another_d_nc_or_nsubc(built, tmp_path, cfg):
    _, t, _, _ = built
    path = str(tmp_path / "a.index")
    t.write(path)
    r = IVFADCGroupingIndex(IndexConfig(code_size=8, **cfg), "cpu")
    with pytest.raises(ValueError):
        r.read(path)


def test_read_rejects_a_cut_file(built, tmp_path):
    _, t, _, _ = built
    path, cut = str(tmp_path / "a.index"), str(tmp_path / "cut.index")
    t.write(path)
    with open(cut, "wb") as f:
        f.write(_bytes(path)[:-100])
    with pytest.raises(ValueError):
        _fresh_port(t).read(cut)
    with open(cut, "wb") as f:
        f.write(_bytes(path)[:10])
    with pytest.raises(ValueError):
        _fresh_port(t).read(cut)


def test_write_needs_a_built_index(tmp_path):
    g = IVFADCGroupingIndex(IndexConfig(**CFG), "cpu")
    g.set_centroids(np.zeros((32, 32), np.float32))
    with pytest.raises(RuntimeError):
        g.write(str(tmp_path / "g.index"))


def test_read_then_add_equals_a_one_shot_build(built, tmp_path):
    """read() seeds the builder, so read -> add_batch -> finalize -> write
    gives the bytes of one build over the same vectors with the same
    alphas: the first 6000 vectors written, read back, 2000 more added."""
    _, t, base, _ = built
    ids = np.arange(base.shape[0], dtype=np.int32) * 2 + 5
    keys = t.assign(base)

    def build(parts):
        g = _fresh_port(t)
        g.nn_centroid_idxs, g.alphas = t.nn_centroid_idxs, t.alphas
        g.inter_centroid_dists = t.inter_centroid_dists
        for lo, hi in parts:
            g.add_batch(base[lo:hi], ids[lo:hi], keys[lo:hi])
        g.finalize()
        return g

    one, part = str(tmp_path / "one.index"), str(tmp_path / "part.index")
    build([(0, 6000), (6000, 8000)]).write(one)
    build([(0, 6000)]).write(part)
    r = _fresh_port(t)
    r.read(part)
    assert r.store.ntotal == 6000
    r.add_batch(base[6000:], ids[6000:], keys[6000:])
    r.finalize()
    assert r.store.ntotal == 8000
    again = str(tmp_path / "again.index")
    r.write(again)
    assert _bytes(again) == _bytes(one)


def test_dump_inter_centroid_dists_matches_jax(built, tmp_path):
    j, t, _, _ = built
    pj, pt = str(tmp_path / "j.log"), str(tmp_path / "t.log")
    j.dump_inter_centroid_dists(pj)
    t.dump_inter_centroid_dists(pt)
    text = _bytes(pt)
    assert text == _bytes(pj)
    assert text.count(b"\n") == 32 * 8
    assert text.startswith(b"distance of centriod 0 to centriod 0 is ")
