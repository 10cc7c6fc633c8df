"""Parity of the port's file IO (ivfhnsw_tpu_torch: utils/io.py,
utils/faiss_io.py, ProductQuantizer / NormQuantizer save and load, OPQ
save_rotation / load_rotation, IVFADCIndex write / read / save_quantizers /
load_quantizers / load_centroids) with the JAX package, on the CPU.

Tolerance: none. Files written from the same state are byte-identical,
arrays read back are equal, and a written-then-read index searches with
equal distances and labels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu.ops import opq as jopq
from ivfhnsw_tpu.ops.pq import NormQuantizer as JaxNormQuantizer
from ivfhnsw_tpu.ops.pq import ProductQuantizer as JaxProductQuantizer
from ivfhnsw_tpu.utils import io as jio
from ivfhnsw_tpu_torch import IndexConfig, IVFADCGroupingIndex, IVFADCIndex
from ivfhnsw_tpu_torch import SearchParams
from ivfhnsw_tpu_torch.ops import opq as topq
from ivfhnsw_tpu_torch.ops.pq import NormQuantizer, ProductQuantizer
from ivfhnsw_tpu_torch.utils import io as tio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    """A JAX index (d=32, nc=64, code_size=8, 9000 codes, three empty
    lists) and the port's index carried across from its arrays, with
    JAX's centroid norms (the packages sum ||c||^2 in different orders)."""
    rng = np.random.RandomState(9)
    nb, d = 9000, 32
    centers = rng.randn(48, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, nb)] + rng.randn(nb, d).astype(
        np.float32)
    j = JaxIndex(JaxConfig(d=d, nc=64, code_size=8))
    cents = base[rng.choice(nb, 64, replace=False)]
    cents[:3] += 1000.0                          # lists 0-2 stay empty
    j.set_centroids(cents)
    j.train_pq(jax.random.PRNGKey(0), base[:4000], pq_niter=5)
    j.add_batch(base, np.arange(nb, dtype=np.int32) * 3 + 7)
    j.finalize()
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=d, nc=64, code_size=8), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, "cpu")
    t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
    return j, t, base


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_store(a, b):
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))


def test_index_file_bytes_identical(built, tmp_path):
    j, t, _ = built
    assert (np.diff(j.store.list_offsets) == 0).sum() >= 3
    j.write(str(tmp_path / "j.index"))
    t.write(str(tmp_path / "t.index"))
    assert _bytes(tmp_path / "j.index") == _bytes(tmp_path / "t.index")


def test_quantizer_file_bytes_identical(built, tmp_path):
    j, t, _ = built
    j.save_quantizers(str(tmp_path / "j.pq"), str(tmp_path / "j.norm_pq"))
    t.save_quantizers(str(tmp_path / "t.pq"), str(tmp_path / "t.norm_pq"))
    for ext in ("pq", "norm_pq"):
        assert _bytes(tmp_path / f"j.{ext}") == _bytes(tmp_path / f"t.{ext}")


def test_opq_rotation_bytes_identical_and_cross_read(tmp_path):
    q, _ = np.linalg.qr(np.random.RandomState(2).randn(16, 16))
    R = q.astype(np.float32)
    jopq.save_rotation(str(tmp_path / "j.opq"), jnp.asarray(R))
    topq.save_rotation(str(tmp_path / "t.opq"), torch.from_numpy(R))
    assert _bytes(tmp_path / "j.opq") == _bytes(tmp_path / "t.opq")
    np.testing.assert_array_equal(
        topq.load_rotation(str(tmp_path / "j.opq"), "cpu").numpy(), R)
    np.testing.assert_array_equal(
        np.asarray(jopq.load_rotation(str(tmp_path / "t.opq"))), R)


def test_opq_index_saves_and_loads_its_rotation(built, tmp_path):
    j, t, _ = built
    cfg = IndexConfig(d=32, nc=64, code_size=8, do_opq=True)
    a, b = IVFADCIndex(cfg, "cpu"), IVFADCIndex(cfg, "cpu")
    a.pq, a.norm_pq = t.pq, t.norm_pq
    a.opq_R = torch.linalg.qr(torch.randn(32, 32, generator=torch.Generator(
        ).manual_seed(0)))[0]
    paths = [str(tmp_path / n) for n in ("a.pq", "a.norm_pq", "a.opq")]
    a.save_quantizers(*paths)
    b.load_quantizers(*paths)
    assert torch.equal(b.opq_R, a.opq_R)
    assert torch.equal(b.pq.codebooks, a.pq.codebooks)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_index(built, tmp_path, writer):
    j, t, _ = built
    path = str(tmp_path / "x.index")
    (j if writer == "jax" else t).write(path)
    if writer == "jax":
        r = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), "cpu")
        r.read(path)
        _same_store(r.store, j.store)
        np.testing.assert_array_equal(r.centroid_norms.numpy(),
                                      np.asarray(j.centroid_norms))
    else:
        r = JaxIndex(JaxConfig(d=32, nc=64, code_size=8))
        r.read(path)
        _same_store(r.store, t.store)
        np.testing.assert_array_equal(np.asarray(r.centroid_norms),
                                      t.centroid_norms.numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_quantizers(built, tmp_path, writer):
    j, t, _ = built
    pq, npq = str(tmp_path / "x.pq"), str(tmp_path / "x.norm_pq")
    (j if writer == "jax" else t).save_quantizers(pq, npq)
    ref_cb = np.asarray(j.pq.codebooks)
    ref_norm = np.asarray(j.norm_pq.centroids)
    if writer == "jax":
        r = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), "cpu")
        r.load_quantizers(pq, npq)
        cb, norm = r.pq.codebooks.numpy(), r.norm_pq.centroids.numpy()
        assert (r.pq.d, r.pq.M, r.pq.ksub) == (32, 8, 256)
    else:
        r = JaxIndex(JaxConfig(d=32, nc=64, code_size=8))
        r.load_quantizers(pq, npq)
        cb, norm = np.asarray(r.pq.codebooks), np.asarray(r.norm_pq.centroids)
    np.testing.assert_array_equal(cb, ref_cb)
    np.testing.assert_array_equal(norm, ref_norm)


def test_written_then_read_index_searches_equal(built, tmp_path):
    _, t, base = built
    paths = {n: str(tmp_path / n) for n in ("a.index", "a.pq", "a.norm_pq",
                                            "a.fvecs")}
    t.write(paths["a.index"])
    t.save_quantizers(paths["a.pq"], paths["a.norm_pq"])
    tio.write_xvec(paths["a.fvecs"], t.centroids.numpy())
    r = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), "cpu")
    r.load_centroids(paths["a.fvecs"])
    r.load_quantizers(paths["a.pq"], paths["a.norm_pq"])
    r.read(paths["a.index"])
    q = base[:40] + 0.1
    for engine, layout in (("torch", "auto"), ("fused", "chunk"),
                           ("fused", "quad")):
        p = SearchParams(k=10, nprobe=8, max_codes=300)
        t.engine = r.engine = engine
        t.scan_layout = r.scan_layout = layout
        d1, l1 = t.search(q, p)
        d2, l2 = r.search(q, p)
        np.testing.assert_array_equal(d2, d1)
        np.testing.assert_array_equal(l2, l1)
    t.engine = t.scan_layout = "auto"


def test_read_index_extends_with_add_batch(built, tmp_path):
    """read() seeds the builder, so add_batch + finalize append to the
    store read from the file, as they would to the index that wrote it."""
    _, t, base = built
    path = str(tmp_path / "a.index")
    t.write(path)
    r = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), "cpu")
    r.set_centroids(t.centroids)
    r.pq, r.norm_pq = t.pq, t.norm_pq
    r.read(path)
    extra = base[:500] + 0.01
    ids = np.arange(500, dtype=np.int32) + 100_000
    r.add_batch(extra, ids)
    r.finalize()
    ref = IVFADCIndex.from_numpy_state(
        IndexConfig(d=32, nc=64, code_size=8), t.centroids.numpy(),
        t.pq.codebooks.numpy(), t.norm_pq.centroids.numpy(), t.store.codes,
        t.store.ids, t.store.norm_codes, t.store.list_offsets, "cpu")
    ref.add_batch(extra, ids)
    ref.finalize()
    assert r.store.ntotal == t.store.ntotal + 500
    _same_store(r.store, ref.store)


@pytest.mark.parametrize("cfg", [dict(d=32, nc=32), dict(d=16, nc=64)])
def test_read_rejects_another_d_or_nc(built, tmp_path, cfg):
    _, t, _ = built
    path = str(tmp_path / "a.index")
    t.write(path)
    r = IVFADCIndex(IndexConfig(code_size=8, **cfg), "cpu")
    with pytest.raises(ValueError):
        r.read(path)


def test_read_accepts_a_file_without_centroid_norms(built, tmp_path):
    """The trailing centroid-norm record is optional (the JAX reader's
    ivfadc.py:920-925): without it the index keeps its own norms."""
    _, t, _ = built
    path = str(tmp_path / "a.index")
    t.write(path)
    raw = _bytes(path)
    cut = str(tmp_path / "cut.index")
    with open(cut, "wb") as f:
        f.write(raw[:len(raw) - 4 - 4 * 64])
    r = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), "cpu")
    own = torch.full((64,), 7.0)
    r.centroid_norms = own
    r.read(cut)
    _same_store(r.store, t.store)
    assert r.centroid_norms is own
    j = JaxIndex(JaxConfig(d=32, nc=64, code_size=8))
    j.read(cut)
    _same_store(j.store, r.store)


def test_legacy_quantizer_headers_are_sniffed(tmp_path):
    """The JAX package's round-1 layouts: PQ [u32 d | u32 M | u32 ksub |
    f32 blob], norm PQ [u32 ksub | f32 blob]; both packages read them."""
    rng = np.random.RandomState(4)
    cb = rng.randn(4, 256, 2).astype(np.float32)
    with open(tmp_path / "old.pq", "wb") as f:
        np.asarray([8, 4, 256], "<u4").tofile(f)
        cb.tofile(f)
    cents = np.sort(rng.rand(256).astype(np.float32))
    with open(tmp_path / "old.norm_pq", "wb") as f:
        np.asarray([256], "<u4").tofile(f)
        cents.tofile(f)
    pq = ProductQuantizer.load(str(tmp_path / "old.pq"), "cpu")
    assert (pq.d, pq.M, pq.ksub) == (8, 4, 256)
    np.testing.assert_array_equal(pq.codebooks.numpy(), cb)
    np.testing.assert_array_equal(
        np.asarray(JaxProductQuantizer.load(str(tmp_path / "old.pq"))
                   .codebooks), cb)
    nq = NormQuantizer.load(str(tmp_path / "old.norm_pq"), "cpu")
    np.testing.assert_array_equal(nq.centroids.numpy(), cents)
    np.testing.assert_array_equal(
        np.asarray(JaxNormQuantizer.load(str(tmp_path / "old.norm_pq"))
                   .centroids), cents)


def test_norm_quantizer_load_sorts(tmp_path):
    """A faiss norm PQ with unsorted centroids loads sorted ascending, as
    the JAX package's NormQuantizer.load leaves it."""
    from ivfhnsw_tpu_torch.utils import faiss_io
    cents = np.random.RandomState(5).rand(256).astype(np.float32)
    path = str(tmp_path / "u.norm_pq")
    faiss_io.write_product_quantizer(path, cents.reshape(1, -1, 1))
    got = NormQuantizer.load(path, "cpu").centroids.numpy()
    np.testing.assert_array_equal(got, np.sort(cents))
    np.testing.assert_array_equal(
        got, np.asarray(JaxNormQuantizer.load(path).centroids))


@pytest.mark.parametrize("ext,dtype", [(".fvecs", np.float32),
                                       (".bvecs", np.uint8),
                                       (".ivecs", np.int32)])
def test_xvec_files_match_jax(tmp_path, ext, dtype):
    rng = np.random.RandomState(6)
    data = (rng.rand(50, 12) * 200).astype(dtype)
    pj, pt = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
    jio.write_xvec(pj, data)
    tio.write_xvec(pt, data)
    assert _bytes(pj) == _bytes(pt)
    tio.write_xvec(pt, data[:5], append=True)
    jio.write_xvec(pj, data[:5], append=True)
    assert _bytes(pj) == _bytes(pt)
    assert tio.infer_xvec_dim(pt, dtype) == jio.infer_xvec_dim(pj, dtype)
    assert tio.xvec_count(pt, 12, dtype) == jio.xvec_count(pj, 12, dtype) == 55
    for kw in ({}, {"n": 7, "offset": 40}, {"n": 3, "offset": 2,
                                            "mmap": True}):
        np.testing.assert_array_equal(tio.read_xvec(pt, 12, **kw),
                                      jio.read_xvec(pj, 12, **kw))
    got = tio.read_xvec_fvec(pt, 12, 10, 3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.read_xvec_fvec(pj, 12, 10, 3))
    with pytest.raises(ValueError):
        tio.read_xvec(pt, 12, n=60)
    with pytest.raises(ValueError):
        tio.read_xvec(pt, 11 if dtype != np.uint8 else 13)


def test_len_series_and_variables_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    counts = np.array([3, 0, 5, 1, 0, 9])
    payload = rng.randint(0, 2 ** 31, counts.sum()).astype("<u4")
    pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
    for mod, p in ((jio, pj), (tio, pt)):
        with open(p, "wb") as f:
            mod.write_variable(f, 128, "<u8")
            mod.write_len_series(f, payload, counts)
            mod.write_len_vector(f, payload[:4])
    assert _bytes(pj) == _bytes(pt)
    buf = tio.read_file_u8(str(pt))
    flat, got_counts, pos = tio.read_len_series(buf, 8, len(counts), "<u4")
    np.testing.assert_array_equal(flat, payload)
    np.testing.assert_array_equal(got_counts, counts)
    assert pos == os.path.getsize(pt) - 4 - 16
    with open(pt, "rb") as ft, open(pj, "rb") as fj:
        assert tio.read_variable(ft, "<u8") == jio.read_variable(
            fj, "<u8") == 128


def test_grouping_index_file_format_is_not_ported(tmp_path):
    """It is ported now (tests/test_torch_grouping_io.py holds it against
    the JAX package's): a grouping index writes its own ``.index`` layout,
    [u64 d | u64 nc | u64 nsubc | ...], and reads it back; an unbuilt index
    has nothing to write, and IVFADC's reader refuses the file."""
    cfg = IndexConfig(d=32, nc=8, code_size=8, nsubc=4)
    g = IVFADCGroupingIndex(cfg, "cpu")
    with pytest.raises(RuntimeError):
        g.write(str(tmp_path / "g.index"))
    rng = np.random.RandomState(8)
    base = rng.randn(600, 32).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    g.train_centroids(gen, base, niter=4)
    g.compute_neighbor_centroids()
    g.train_pq(gen, base, pq_niter=3)
    g.add(base)
    g.finalize()
    path = str(tmp_path / "g.index")
    g.write(path)
    assert np.frombuffer(_bytes(path)[:24], "<u8").tolist() == [32, 8, 4]
    r = IVFADCGroupingIndex(cfg, "cpu")
    r.read(path)
    _same_store(r.store, g.store)
    assert torch.equal(r.alphas, g.alphas)
    assert torch.equal(r.nn_centroid_idxs, g.nn_centroid_idxs)
    with pytest.raises(ValueError):
        IVFADCIndex(IndexConfig(d=32, nc=8, code_size=8), "cpu").read(path)
