"""The port's file-backed pipeline (ivfhnsw_tpu_torch: utils/io.py helpers,
utils/recall.py::rerank_order, RunConfig JSON, drivers/common.py's
FileDataset and artifact caching, and the drivers ivfadc_eval,
grouping_eval, vector_add and disk_rerank) against the JAX package, on the
CPU (``-device cpu``: the kernels' plain versions).

Inputs come from a seed with numpy; the corpora are written to the test's
temporary directory. Tolerances: none for files and arrays read back
(equal bytes, equal arrays) and for a second run of one package over its
own artifacts (equal labels); a search by one package over the artifacts
the other wrote is held to the cross-engine contract (rtol=1e-4,
atol=1e-3, labels differ only where distances tie); the alphas of the two
packages' incremental builds over the same quantizers agree within 1e-5
(f32 sums in another order) except in groups where a point sits at a
near-tie between two candidate directions, which the test allows by the
size that one moved point can have.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.drivers import common as JC
from ivfhnsw_tpu.utils import config as jconfig
from ivfhnsw_tpu.utils import io as jio
from ivfhnsw_tpu.utils import recall as jrecall
from ivfhnsw_tpu_torch import IndexConfig, IVFADCGroupingIndex, IVFADCIndex
from ivfhnsw_tpu_torch import SearchParams
from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.drivers import (disk_rerank, grouping_eval,
                                       ivfadc_eval, vector_add)
from ivfhnsw_tpu_torch.utils import config as tconfig
from ivfhnsw_tpu_torch.utils import io as tio
from ivfhnsw_tpu_torch.utils import recall as trecall

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
SIZES = ("-d 32 -nc 32 -code_size 8 -nb 4000 -nt 3000 -nq 50 -ngt 1 -k 10 "
         "-nprobe 8 -max_codes 1000")
GROUPING = " -nsubc 8 -do_opq on -do_pruning on"


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


def run_jax(mod, args):
    """A JAX driver on a command line (it reads sys.argv)."""
    old = sys.argv
    sys.argv = ["driver"] + args.split()
    try:
        return __import__(f"ivfhnsw_tpu.drivers.{mod}",
                          fromlist=["main"]).main()
    finally:
        sys.argv = old


# ---------------------------------------------------------------------------
# utils/io.py helpers and rerank_order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,dtype", [(".fvecs", np.float32),
                                       (".bvecs", np.uint8)])
def test_xvec_file_gather_and_batches_match_jax(tmp_path, ext, dtype):
    rng = np.random.RandomState(1)
    data = (rng.rand(70, 12) * 200).astype(dtype)
    path = str(tmp_path / ("x" + ext))
    tio.write_xvec(path, data)
    a, b = tio.XvecFile(path, 12), jio.XvecFile(path, 12)
    assert len(a) == len(b) == 70 and a.dtype == b.dtype == dtype
    idx = np.array([69, 0, 5, 5, 33])
    got = a.gather(idx)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, b.gather(idx))
    np.testing.assert_array_equal(got, data[idx].astype(np.float32))
    assert a.gather(np.zeros(0, np.int64)).shape == (0, 12)
    for kw in ({}, {"limit": 45}):
        mine = list(tio.iter_xvec_batches(path, 12, 20, **kw))
        theirs = list(jio.iter_xvec_batches(path, 12, 20, **kw))
        assert [m.shape[0] for m in mine] == [t.shape[0] for t in theirs]
        np.testing.assert_array_equal(np.concatenate(mine),
                                      np.concatenate(theirs))
    assert tio.base_vec_num(path, 12, dtype) == jio.base_vec_num(
        path, 12, dtype) == 70
    with pytest.raises(ValueError):
        tio.base_vec_num(path, 11 if dtype != np.uint8 else 13, dtype)


@pytest.mark.parametrize("dtype", ["<u4", "<f4"])
def test_len_rows_and_len_vector_match_jax(tmp_path, dtype):
    rng = np.random.RandomState(2)
    rows = (rng.rand(9, 5) * 1000).astype(dtype)
    pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
    for mod, p in ((jio, pj), (tio, pt)):
        with open(p, "wb") as f:
            mod.write_len_rows(f, rows)
            mod.write_len_vector(f, rows[0])
    assert _bytes(pj) == _bytes(pt)
    buf = tio.read_file_u8(str(pt))
    got, pos = tio.read_len_rows(buf, 0, 9, 5, dtype)
    ref, pos_j = jio.read_len_rows(jio.read_file_u8(str(pj)), 0, 9, 5, dtype)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got, ref)
    assert pos == pos_j == 9 * (4 + 20)
    with open(pt, "rb") as ft, open(pj, "rb") as fj:
        ft.seek(pos)
        fj.seek(pos)
        np.testing.assert_array_equal(tio.read_len_vector(ft, dtype),
                                      jio.read_len_vector(fj, dtype))
    with pytest.raises(ValueError):                       # ragged: w is 5
        tio.read_len_rows(buf, 0, 9, 4, dtype)
    with pytest.raises(ValueError):                       # past the end
        tio.read_len_rows(buf, 0, 11, 5, dtype)


def test_segment_file_helpers_match_jax(tmp_path):
    for name in ("base_01.fvecs", "base_00.fvecs", "idx_00.ivecs", ".fvecs",
                 "notes.txt", "base_02.fvecs.bak"):
        (tmp_path / name).write_bytes(b"")
    for ext in (".fvecs", ".ivecs", ".bvecs"):
        assert tio.get_files(str(tmp_path), ext) == jio.get_files(
            str(tmp_path), ext)
    assert tio.get_files(str(tmp_path), ".fvecs") == [
        "base_00.fvecs", "base_01.fvecs", "base_02.fvecs.bak"]
    tio.check_files("base_", ["base_00.fvecs", "base_01.fvecs"])
    for mod in (tio, jio):
        with pytest.raises(ValueError):
            mod.check_files("base_", ["base_00.fvecs", "idx_00.ivecs"])
    for i in (0, 7, 12):
        assert tio.get_index_name("/x/index", i) == jio.get_index_name(
            "/x/index", i)
    assert tio.get_index_name("/x/index", 3) == "/x/index_03.index"


def test_rerank_order_matches_jax():
    rng = np.random.RandomState(3)
    d = rng.rand(40).astype(np.float32)
    d[5:9] = d[5] + np.array([0, 2e-4, 4e-4, 6e-4], np.float32)  # one bucket
    labels = rng.permutation(40).astype(np.int64)
    for eps in (1e-3, 1e-1):
        dd, ll = trecall.rerank_order(d, labels, eps)
        dj, lj = jrecall.rerank_order(d, labels, eps)
        np.testing.assert_array_equal(dd, dj)
        np.testing.assert_array_equal(ll, lj)
    dd, ll = trecall.rerank_order(np.zeros(0, np.float32),
                                  np.zeros(0, np.int64))
    assert dd.shape == ll.shape == (0,)
    # Within one eps bucket the smaller label comes first.
    dd, ll = trecall.rerank_order(np.array([0.5003, 0.5001], np.float32),
                                  np.array([2, 9]))
    assert ll.tolist() == [2, 9]


# ---------------------------------------------------------------------------
# RunConfig JSON, and the flags the reference accepts without using them
# ---------------------------------------------------------------------------

def test_run_config_json_crosses_the_packages():
    argv = (SIZES + GROUPING + " -path_base b.bvecs -path_info i.bin "
            "-path_edges e.bin -path_index x.index -coarse_mode exact").split()
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    text = t.to_json()
    assert text == j.to_json()
    assert jconfig.RunConfig.from_json(text).to_json() == text
    back = tconfig.RunConfig.from_json(j.to_json())
    assert back.to_json() == text
    assert back.index.nsubc == 8 and back.search.do_pruning is True
    assert back.path_edges == "e.bin"


def test_graph_file_flags_are_accepted_and_unused(capsys):
    """The reference's command lines name an HNSW graph (-path_info,
    -path_edges); there is no graph here, and the files need not exist."""
    res = ivfadc_eval.main(
        ("-synthetic 0 -device cpu -path_info x.bin -path_edges y.bin "
         + SIZES).split())
    assert res["recalls"][10] > 0.3
    assert "Recall@1:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# FileDataset and the artifact-cached drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A clustered corpus as base.fvecs / learn.fvecs / query.fvecs /
    gt.ivecs (exact nearest neighbours by numpy), and its flags."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(7)
    centers = rng.randn(40, 32).astype(np.float32) * 5

    def draw(n):
        return centers[rng.randint(0, 40, n)] + rng.randn(n, 32).astype(
            np.float32)
    base, learn, queries = draw(4000), draw(3000), draw(50)
    gt = ((queries[:, None, :] - base[None]) ** 2).sum(-1).argmin(1)
    tio.write_xvec(str(root / "base.fvecs"), base)
    tio.write_xvec(str(root / "learn.fvecs"), learn)
    tio.write_xvec(str(root / "query.fvecs"), queries)
    tio.write_xvec(str(root / "gt.ivecs"), gt[:, None].astype(np.int32))
    flags = (f" -path_base {root}/base.fvecs -path_learn {root}/learn.fvecs"
             f" -path_q {root}/query.fvecs -path_gt {root}/gt.ivecs")
    return {"root": root, "base": base, "learn": learn, "queries": queries,
            "gt": gt, "flags": flags}


def _artifact_flags(d):
    return (f" -path_centroids {d}/c.fvecs -path_pq {d}/x.pq"
            f" -path_norm_pq {d}/x.norm_pq -path_opq_matrix {d}/x.opq"
            f" -path_precomputed_idxs {d}/idxs.ivecs"
            f" -path_index {d}/x.index")


def test_file_dataset_matches_jax(corpus):
    argv = (SIZES + corpus["flags"]).split()
    t = C.get_dataset(tconfig.parse_args(argv), None, "cpu")
    j = JC.get_dataset(jconfig.parse_args(argv))
    assert isinstance(t, C.FileDataset)
    assert t.total_base == j.total_base == 4000
    np.testing.assert_array_equal(t.queries, j.queries)
    np.testing.assert_array_equal(t.gt, j.gt)
    assert t.gt.dtype == np.int64 and t.gt.shape == (50, 1)
    np.testing.assert_array_equal(t.learn, j.learn)
    mine, theirs = list(t.base_batches(1500)), list(j.base_batches(1500))
    assert [o for o, _ in mine] == [o for o, _ in theirs] == [0, 1500, 3000]
    for (_, a), (_, b) in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    # counts left at 0 come from the files' sizes
    for flag in ("-nb", "-nq", "-nt"):
        argv[argv.index(flag) + 1] = "0"
    whole = C.get_dataset(tconfig.parse_args(argv), None, "cpu")
    assert (whole.total_base, whole.nq, whole.learn.shape[0]) == (4000, 50,
                                                                  3000)
    assert whole.gt.shape == (50, 1)
    # no -path_base and no -synthetic: the synthetic corpus of seed 0
    cfg = tconfig.parse_args(SIZES.split())
    a, b = C.get_dataset(cfg, None, "cpu"), C.get_dataset(cfg, 0, "cpu")
    assert isinstance(a, C.SyntheticDataset)
    np.testing.assert_array_equal(a.base, b.base)


def _forbid_building(monkeypatch, cls):
    def refuse(*args, **kwargs):
        raise AssertionError("a cached stage was computed again")
    for name in ("train_centroids", "train_pq", "_assign_t", "add_batch"):
        monkeypatch.setattr(cls, name, refuse)
    if cls is IVFADCGroupingIndex:
        monkeypatch.setattr(cls, "alpha_pass", refuse)


@pytest.mark.parametrize("name", ["ivfadc_eval", "grouping_eval"])
def test_driver_resumes_from_its_files_and_crosses_packages(
        name, corpus, tmp_path, monkeypatch):
    drv = {"ivfadc_eval": ivfadc_eval, "grouping_eval": grouping_eval}[name]
    cls = {"ivfadc_eval": IVFADCIndex,
           "grouping_eval": IVFADCGroupingIndex}[name]
    extra = GROUPING if name == "grouping_eval" else ""
    dir_t, dir_j = tmp_path / "port", tmp_path / "jax"
    dir_t.mkdir()
    dir_j.mkdir()
    args_t = SIZES + extra + corpus["flags"] + _artifact_flags(dir_t)
    args_j = SIZES + extra + corpus["flags"] + _artifact_flags(dir_j)

    r1 = drv.main((args_t + " -device cpu").split())
    assert r1["stages"]["how"] == {"centroids": "trained", "pq": "trained",
                                   "assign": "computed", "index": "built"}
    assert "write" in r1["stages"]["seconds"]
    files = {"c.fvecs", "x.pq", "x.norm_pq", "idxs.ivecs", "x.index"}
    if extra:
        files.add("x.opq")
    assert set(os.listdir(dir_t)) == files
    assert r1["recalls"][10] > 0.3

    # run 2 must load every artifact: computing any stage again raises
    with monkeypatch.context() as m:
        _forbid_building(m, cls)
        r2 = drv.main((args_t + " -device cpu").split())
    assert r2["stages"]["how"] == {"centroids": "loaded", "pq": "loaded",
                                   "assign": "loaded", "index": "read"}
    assert set(r2["stages"]["seconds"]) >= {"centroids", "pq", "assign",
                                            "read"}
    np.testing.assert_array_equal(r2["labels"], r1["labels"])
    np.testing.assert_array_equal(r2["dists"], r1["dists"])
    assert r2["recalls"] == r1["recalls"]

    # the JAX driver over the files the port wrote
    rj = run_jax(name, args_t)
    assert_same(r1["dists"], r1["labels"], np.asarray(rj["dists"]),
                np.asarray(rj["labels"]))

    # the port over the files the JAX driver wrote
    rj1 = run_jax(name, args_j)
    assert set(os.listdir(dir_j)) == files
    with monkeypatch.context() as m:
        _forbid_building(m, cls)
        rt = drv.main((args_j + " -device cpu").split())
    assert rt["stages"]["how"]["index"] == "read"
    assert_same(np.asarray(rj1["dists"]), np.asarray(rj1["labels"]),
                rt["dists"], rt["labels"])


def test_synthetic_run_caches_its_artifacts_too(tmp_path):
    """-synthetic with -path_* flags: the artifacts are written and the
    second run reads them (the reference's drivers gate on the files, not
    on where the corpus came from)."""
    args = ("-synthetic 0 -device cpu " + SIZES
            + _artifact_flags(tmp_path)).split()
    r1 = ivfadc_eval.main(args)
    r2 = ivfadc_eval.main(args)
    assert r1["stages"]["how"]["index"] == "built"
    assert r2["stages"]["how"] == {"centroids": "loaded", "pq": "loaded",
                                   "assign": "loaded", "index": "read"}
    np.testing.assert_array_equal(r2["labels"], r1["labels"])
    assert not (tmp_path / "x.opq").exists()              # do_opq is off


class _KeyedIndex:
    """An index whose assignment of a row is the row's first column."""

    def assign(self, x):
        return np.asarray(x)[:, 0].astype(np.int32)


class _KeyedDataset:
    def __init__(self, keys, batch):
        self.rows = np.stack([keys, keys], axis=1).astype(np.float32)
        self.batch = batch

    @property
    def total_base(self):
        return self.rows.shape[0]

    def base_batches(self):
        for off in range(0, self.total_base, self.batch):
            yield off, self.rows[off:off + self.batch]


def test_assignment_file_bytes_match_jax(tmp_path, monkeypatch):
    """load_or_assign's .ivecs: records [u32 n | n x u32] of ASSIGN_BATCH
    entries (1000 here), the last one shorter."""
    monkeypatch.setattr(C, "ASSIGN_BATCH", 1000)
    monkeypatch.setattr(JC, "ASSIGN_BATCH", 1000)
    keys = np.random.RandomState(4).randint(0, 4096, 2500)
    ds = _KeyedDataset(keys, 700)
    pt, pj = str(tmp_path / "t.ivecs"), str(tmp_path / "j.ivecs")
    cfg_t = tconfig.RunConfig(path_precomputed_idxs=pt)
    cfg_j = jconfig.RunConfig(path_precomputed_idxs=pj)
    it = C.load_or_assign(_KeyedIndex(), cfg_t, ds)
    ij = JC.load_or_assign(_KeyedIndex(), cfg_j, ds)
    np.testing.assert_array_equal(it, keys)
    np.testing.assert_array_equal(ij, keys)
    raw = _bytes(pt)
    assert raw == _bytes(pj)
    assert len(raw) == 4 * (2500 + 3)
    assert np.frombuffer(raw[:4], "<u4")[0] == 1000
    # each package loads the other's file, without assigning
    cfg_t.path_precomputed_idxs, cfg_j.path_precomputed_idxs = pj, pt
    got = C.load_or_assign(None, cfg_t, ds)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, keys)
    np.testing.assert_array_equal(JC.load_or_assign(None, cfg_j, ds), keys)
    np.testing.assert_array_equal(vector_add.read_idx_segment(pj), keys)
    # a file with fewer assignments than base vectors is refused
    C.write_assignments(pt, keys[:2000])
    cfg_t.path_precomputed_idxs = pt
    with pytest.raises(ValueError):
        C.load_or_assign(None, cfg_t, ds)
    with open(pt, "wb") as f:                             # a cut record
        np.asarray([10, 1, 2], "<u4").tofile(f)
    with pytest.raises(ValueError):
        C.read_assignments(pt)


# ---------------------------------------------------------------------------
# vector_add
# ---------------------------------------------------------------------------

VA_SIZES = ("-synthetic 0 -d 16 -nc 32 -code_size 4 -nb 5000 -nt 3000 "
            "-nq 50 -k 10 -nprobe 8 -max_codes 1000 -nsubc 4")


def test_vector_add_matches_jax_segment_by_segment(tmp_path):
    quant = (f" -path_centroids {tmp_path}/c.fvecs -path_pq {tmp_path}/x.pq"
             f" -path_norm_pq {tmp_path}/x.norm_pq")
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    out_t.mkdir()
    out_j.mkdir()
    rt = vector_add.main((VA_SIZES + quant + " -segments 3 -device cpu"
                          f" -path_index {out_t}/index").split())
    rj = run_jax("vector_add", VA_SIZES + quant + " -segments 3"
                 f" -path_index {out_j}/index")
    assert [r["ntotal"] for r in rt] == [r["ntotal"] for r in rj] == [
        1667, 3334, 5000]
    names = ["index_00.index", "index_01.index", "index_02.index"]
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == names
    assert rt[-1]["recalls"][10] >= rt[0]["recalls"][10]
    cfg = IndexConfig(d=16, nc=32, code_size=4, nsubc=4)
    for i, name in enumerate(names):
        a = IVFADCGroupingIndex(cfg, "cpu")
        a.read(str(out_t / name))
        b = IVFADCGroupingIndex(cfg, "cpu")
        b.read(str(out_j / name))
        assert a.store.ntotal == b.store.ntotal == rt[i]["ntotal"]
        np.testing.assert_array_equal(a.alphas.numpy(), rt[i]["alphas"])
        np.testing.assert_array_equal(a.nn_centroid_idxs.numpy(),
                                      b.nn_centroid_idxs.numpy())
        # The alphas are sums over a group's points; one point at a
        # near-tie between two directions may fall the other way in the
        # other package (its share of a group's sums is at most 1 / the
        # group's size), everything else is f32 summation order.
        gsize = np.maximum(a.store.grouped(4).group_sizes, 1)
        diff = np.abs(a.alphas.numpy() - b.alphas.numpy())
        assert (diff <= 1e-5 + 2.0 / gsize).all()
        assert np.median(diff) <= 1e-5
        assert (diff <= 1e-5).mean() >= 0.9


def test_vector_add_consumes_idx_segments(tmp_path, monkeypatch):
    """The segment loop must take its keys from the precomputed-idx
    segment files: count nearest-centroid assignments and allow only the
    one of the quantizer training (setup_pq assigns the train set)."""
    argv = (VA_SIZES + " -device cpu").split()
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    _, ds = C.driver_setup(cfg, extras)
    helper = IVFADCGroupingIndex(cfg.index, "cpu")
    C.setup_quantizer(helper, cfg, ds, torch.Generator().manual_seed(0))
    seg_dir = tmp_path / "segments"
    seg_dir.mkdir()
    vector_add.write_synthetic_segments(helper, ds.base, 2, str(seg_dir))
    assert sorted(os.listdir(seg_dir)) == [
        "base_00.fvecs", "base_01.fvecs", "precomputed_idxs_00.ivecs",
        "precomputed_idxs_01.ivecs"]

    calls = {"n": 0}
    orig = IVFADCGroupingIndex._assign_t

    def counting(self, x):
        calls["n"] += 1
        return orig(self, x)
    monkeypatch.setattr(IVFADCGroupingIndex, "_assign_t", counting)
    res = vector_add.main(argv + ["-segment_dir", str(seg_dir)])
    assert [r["ntotal"] for r in res] == [2500, 5000]
    assert calls["n"] <= 1
    assert os.path.exists(seg_dir / "index_01.index")

    # segment counts that do not pair up are refused, as in the reference
    os.remove(seg_dir / "precomputed_idxs_01.ivecs")
    with pytest.raises(ValueError, match="do not match"):
        vector_add.main(argv + ["-segment_dir", str(seg_dir)])


def test_vector_add_builds_plain_ivfadc_without_nsubc(tmp_path):
    res = vector_add.main(
        (VA_SIZES.replace("-nsubc 4", "-nsubc 0") + " -segments 2 -device cpu"
         f" -path_index {tmp_path}/index").split())
    assert [r["ntotal"] for r in res] == [2500, 5000]
    assert res[-1]["alphas"] is None
    a = IVFADCIndex(IndexConfig(d=16, nc=32, code_size=4), "cpu")
    a.read(str(tmp_path / "index_01.index"))
    assert a.store.ntotal == 5000


# ---------------------------------------------------------------------------
# disk rerank
# ---------------------------------------------------------------------------

GCFG = dict(d=32, nc=32, code_size=8, nsubc=8)


def _jax_grouping(base, n_add):
    import jax
    j = JaxGrouping(JaxConfig(**GCFG))
    key = jax.random.PRNGKey(0)
    j.train_centroids(key, base[:4000], niter=10)
    j.compute_neighbor_centroids()
    j.train_pq(key, base[:3000])
    j.add(base[:n_add], np.arange(n_add, dtype=np.int32))
    j.finalize()
    return j


def _carry(j):
    st = j.store
    return IVFADCGroupingIndex.from_numpy_state(
        IndexConfig(**GCFG), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets,
        np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
        np.asarray(j.inter_centroid_dists), None, "cpu")


@pytest.mark.parametrize("n_add,nprobe,ext", [(4000, 8, ".fvecs"),
                                              (120, 1, ".fvecs"),
                                              (4000, 8, ".bvecs")],
                         ids=["full", "sparse", "bvecs"])
def test_search_disk_matches_jax(corpus, tmp_path, n_add, nprobe, ext):
    """search_disk on the same index and base file in both packages; the
    "sparse" index holds 120 codes in 32 groups and probes one group, so
    queries find fewer than k candidates and pad with (+inf, -1)."""
    base, queries = corpus["base"], corpus["queries"]
    if ext == ".bvecs":
        base = np.clip(np.rint(base * 8 + 128), 0, 255).astype(np.float32)
        queries = np.clip(np.rint(queries * 8 + 128), 0, 255).astype(
            np.float32)
    path = str(tmp_path / ("base" + ext))
    tio.write_xvec(path, base.astype(tio.XVEC_DTYPES[ext]))
    j = _jax_grouping(base, n_add)
    t = _carry(j)
    p = dict(k=10, nprobe=nprobe, max_codes=0, do_pruning=False)
    dj, lj = j.search_disk(queries, JaxParams(**p), jio.XvecFile(path, 32))
    dt, lt = t.search_disk(queries, SearchParams(**p), tio.XvecFile(path, 32))
    assert dt.shape == lt.shape == (50, 10)
    assert dt.dtype == np.float32 and lt.dtype == np.int64
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)
    short = (lt < 0).any(axis=1)
    assert short.any() == (n_add == 120)
    np.testing.assert_array_equal(np.isinf(dt), lt < 0)
    # exact distances, ascending, to the vectors the labels name
    ok = lt[0] >= 0
    ref = ((base[lt[0][ok]] - queries[0]) ** 2).sum(1)
    np.testing.assert_allclose(dt[0][ok], ref, rtol=1e-5)
    assert (np.diff(dt[0][ok]) >= -1e-3).all()


def test_disk_rerank_driver_on_files_beats_the_ann_search(corpus, tmp_path):
    args = (SIZES + GROUPING + corpus["flags"] + _artifact_flags(tmp_path)
            + " -device cpu").split()
    ann = grouping_eval.main(args)
    res = disk_rerank.main(args)
    assert res["stages"]["how"]["index"] == "read"
    assert res["recalls"][10] >= ann["recalls"][10]
    assert res["recalls"][1] >= ann["recalls"][1]
    assert res["labels"].shape == (50, 10)


def test_disk_rerank_driver_synthetic(capsys):
    res = disk_rerank.main(("-synthetic 0 -device cpu " + SIZES
                            + " -nsubc 4").split())
    assert res["recalls"][10] > 0.3
    assert "Time per query" in capsys.readouterr().out
