"""The port's ORCV-era drivers and tool against the JAX package's, on the
CPU (``-device cpu``: the kernels' plain versions): drivers/mkindex.py,
drivers/orca_debug.py, the -orca_obuf branch of drivers/ivfadc_eval.py,
tools/vector_split.py, and drivers/vector_add.py -segment_dir over
vector_split's output.

Every test that runs mkindex or orca_debug (of either package) first
changes into its own temporary directory: both write their logs
(``centriods.log``, ``centroids_hit.log``, ``centroids_miss.log``) into the
working directory.

A clustered corpus is written as base.fvecs / learn.fvecs / query.fvecs /
gt.ivecs; the port's eval drivers write each index kind's artifacts once,
and both packages' drivers then load every one of them, so they search the
same index. Tolerances: none for files (equal bytes) and integer results
(first miss, answer centroid, probe rank, hit / miss split, probes);
distances in the logs within rtol=1e-4, atol=1e-3; the ORCV dir's
cnorms.vec within rtol=1e-6 (D6: ||c||^2 summed in another order) and
opq.vec within rtol=1e-5 (D10).
"""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from ivfhnsw_tpu.utils import orcv as jax_orcv
from ivfhnsw_tpu_torch.drivers import (grouping_eval, ivfadc_eval, mkindex,
                                       orca_debug, vector_add)
from ivfhnsw_tpu_torch.tools import vector_split
from ivfhnsw_tpu_torch.utils import io as tio
from ivfhnsw_tpu_torch.utils import orcv

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ("-d 32 -nc 32 -code_size 8 -nb 4000 -nt 3000 -nq 50 -ngt 1 -k 10 "
         "-nprobe 8 -max_codes 400")
EXTRA = {"ivfadc": "", "grouping": " -nsubc 8 -do_opq on -do_pruning on"}
LOADED = {"centroids": "loaded", "pq": "loaded", "assign": "loaded",
          "index": "read"}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def run_jax(mod, args, capture=None):
    """A JAX driver on a command line (it reads sys.argv)."""
    old = sys.argv
    sys.argv = ["driver"] + args.split()
    try:
        return __import__(f"ivfhnsw_tpu.drivers.{mod}",
                          fromlist=["main"]).main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus files, and each index kind's artifacts written by the
    port's eval driver (centroids, quantizers, assignments, .index)."""
    root = tmp_path_factory.mktemp("orca_corpus")
    rng = np.random.RandomState(11)
    centers = rng.randn(40, 32).astype(np.float32) * 5

    def draw(n):
        return centers[rng.randint(0, 40, n)] + rng.randn(n, 32).astype(
            np.float32) * 1.5
    base, learn, queries = draw(4000), draw(3000), draw(50)
    gt = ((queries[:, None, :] - base[None]) ** 2).sum(-1).argmin(1)
    tio.write_xvec(str(root / "base.fvecs"), base)
    tio.write_xvec(str(root / "learn.fvecs"), learn)
    tio.write_xvec(str(root / "query.fvecs"), queries)
    tio.write_xvec(str(root / "gt.ivecs"), gt[:, None].astype(np.int32))
    flags = (f" -path_base {root}/base.fvecs -path_learn {root}/learn.fvecs"
             f" -path_q {root}/query.fvecs -path_gt {root}/gt.ivecs")
    args = {}
    for kind, drv in (("ivfadc", ivfadc_eval), ("grouping", grouping_eval)):
        d = root / kind
        d.mkdir()
        args[kind] = (SIZES + EXTRA[kind] + flags
                      + f" -path_centroids {d}/c.fvecs -path_pq {d}/x.pq"
                      f" -path_norm_pq {d}/x.norm_pq"
                      f" -path_opq_matrix {d}/x.opq"
                      f" -path_precomputed_idxs {d}/idxs.ivecs"
                      f" -path_index {d}/x.index")
        drv.main((args[kind] + " -device cpu").split())
    return {"root": root, "base": base, "flags": flags, "args": args}


def _blocks(path):
    """The trace log's blocks: {query: [(centroid, distance), ...]}."""
    out, cur = {}, None
    with open(path) as f:
        for line in f:
            m = re.fullmatch(r"query (\d+):\n", line)
            if m:
                cur = out.setdefault(int(m.group(1)), [])
                continue
            c, d = re.fullmatch(r"c: (\d+) d: (\S+)\n", line).groups()
            cur.append((int(c), float(d)))
    return out


def _probe_line(text):
    """(rank, included) of the first miss's answer centroid, or None when
    it was not probed."""
    m = re.search(r"probed at rank (\d+) \(dist \S+, included=(\w+)\)", text)
    if m:
        return int(m.group(1)), m.group(2)
    assert "centroid NOT probed" in text
    return None


@pytest.mark.parametrize("kind", ["ivfadc", "grouping"])
def test_orca_debug_matches_jax(kind, corpus, tmp_path, monkeypatch,
                                capsys):
    """Both packages' orca_debug over the same files: the same first miss,
    answer centroid and probe rank, the same queries in the hit and miss
    logs, with equal probes and distances within tolerance."""
    args = corpus["args"][kind]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    capsys.readouterr()
    rj = run_jax("orca_debug", args)
    out_j = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "port")
    rt = orca_debug.main((args + " -device cpu").split())
    out_t = capsys.readouterr().out
    assert rj is not None, "the corpus must give the driver a miss"
    assert rt == rj
    assert _probe_line(out_t) == _probe_line(out_j)
    assert "reading index" in out_t           # it loaded, it did not build
    assert f"ENN self-search of true answer: id" in out_t
    for log in (orca_debug.HIT_LOG, orca_debug.MISS_LOG):
        bj = _blocks(tmp_path / "jax" / log)
        bt = _blocks(tmp_path / "port" / log)
        assert sorted(bt) == sorted(bj), log
        for qi, probes in bt.items():
            cj, dj = zip(*bj[qi])
            ct, dt = zip(*probes)
            assert ct == cj and len(ct) == 8
            np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    hits = _blocks(tmp_path / "port" / orca_debug.HIT_LOG)
    misses = _blocks(tmp_path / "port" / orca_debug.MISS_LOG)
    assert len(hits) + len(misses) == 50 and rt["query"] == min(misses)

    # the logs are appended to, as the reference's trace_centroids does
    orca_debug.main((args + " -device cpu").split())
    again = _blocks(tmp_path / "port" / orca_debug.MISS_LOG)
    with open(tmp_path / "port" / orca_debug.MISS_LOG) as f:
        assert f.read().count("query ") == 2 * len(misses) == 2 * len(again)


def test_mkindex_matches_jax(corpus, tmp_path, monkeypatch):
    """mkindex of both packages over the flagship's files: every artifact
    loaded (none computed), equal centriods.log, equal ORCV dirs, and each
    package's load_home_dir reads the port's dir to equal stores."""
    args = corpus["args"]["grouping"]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    run_jax("mkindex", args + f" -orcv_home {tmp_path}/jax/orcv")
    monkeypatch.chdir(tmp_path / "port")
    res = mkindex.main((args + f" -orcv_home {tmp_path}/port/orcv"
                        " -device cpu").split())
    assert res["stages"]["how"] == LOADED
    hj, ht = tmp_path / "jax" / "orcv", tmp_path / "port" / "orcv"
    names = {"hdr.vec", "cnorms.vec", "pq.vec", "normpq.vec", "opq.vec",
             "edge.vec"}
    assert set(os.listdir(ht)) == set(os.listdir(hj)) == names
    for name in ("hdr.vec", "pq.vec", "normpq.vec", "edge.vec"):
        assert _bytes(ht / name) == _bytes(hj / name), name
    for name, rtol in (("cnorms.vec", 1e-6), ("opq.vec", 1e-5)):
        a, b = _bytes(ht / name), _bytes(hj / name)
        assert len(a) == len(b) and a[:4] == b[:4], name
        np.testing.assert_allclose(np.frombuffer(a[4:], "<f4"),
                                   np.frombuffer(b[4:], "<f4"), rtol=rtol,
                                   atol=1e-6, err_msg=name)
    lj = (tmp_path / "jax" / mkindex.LOG).read_text().splitlines()
    lt = (tmp_path / "port" / mkindex.LOG).read_text().splitlines()
    assert len(lt) == len(lj) == 32 * 8
    for a, b in zip(lt, lj):
        pa, pb = a.rsplit(" ", 1), b.rsplit(" ", 1)
        assert pa[0] == pb[0]
        np.testing.assert_allclose(float(pa[1]), float(pb[1]), rtol=1e-5,
                                   atol=1e-4)
    pj, hdr_j = jax_orcv.load_home_dir(str(ht))
    pt, hdr_t = orcv.load_home_dir(str(ht), "cpu")
    assert hdr_t == orcv.OrcvHeader(**vars(hdr_j))
    assert hdr_t.n == 4000 and hdr_t.nc == 32 and hdr_t.do_opq == 1
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(getattr(pt.store, name),
                                      np.asarray(getattr(pj.store, name)),
                                      err_msg=name)
    # the shared quirk: the first nc of the nc * nsubc subgroup lists
    store = res["index"].store
    first = int(store.list_offsets[32])
    np.testing.assert_array_equal(pt.store.codes, store.codes[:first])


def test_orca_obuf_matches_jax(corpus, monkeypatch):
    """-orca_obuf over the IVFADC files: add_batch2's buffer of the first
    base batch equals the JAX driver's byte for byte and holds the codes the
    index stores for those vectors; the builder is emptied before the read,
    so the index holds each vector once and searches as a plain run."""
    from ivfhnsw_tpu.models.ivfadc import IVFADCIndex as JaxIndex
    args = corpus["args"]["ivfadc"]
    seen = []
    orig = JaxIndex.add_batch2

    def capture(self, *a, **kw):
        seen.append(orig(self, *a, **kw))
        return seen[-1]
    monkeypatch.setattr(JaxIndex, "add_batch2", capture)
    run_jax("ivfadc_eval", args + " -orca_obuf 1")
    plain = ivfadc_eval.main((args + " -device cpu").split())
    res = ivfadc_eval.main((args + " -orca_obuf 1 -device cpu").split())
    assert "obuf" not in plain and len(seen) == 1
    buf = res["obuf"]
    assert len(buf) == 4000 * (8 + 8 + 1)
    assert buf == seen[0]
    rec = np.frombuffer(buf, dtype=[("eid", "<u8"), ("code", "u1", (8,)),
                                    ("norm", "u1")])
    np.testing.assert_array_equal(rec["eid"], np.arange(4000))
    store = res["index"].store
    assert res["stages"]["how"] == LOADED
    assert store.ntotal == 4000 and res["index"].builder.ntotal == 4000
    order = np.argsort(store.ids)
    np.testing.assert_array_equal(rec["code"], store.codes[order])
    np.testing.assert_array_equal(rec["norm"], store.norm_codes[order])
    np.testing.assert_array_equal(res["labels"], plain["labels"])
    np.testing.assert_array_equal(res["dists"], plain["dists"])


def test_orca_obuf_before_a_build_leaves_one_copy(corpus, tmp_path):
    """With no .index file the driver builds after add_batch2: the builder
    reset keeps the buffer's vectors out of the built index."""
    args = corpus["args"]["ivfadc"].replace(
        f"-path_index {corpus['root']}/ivfadc/x.index",
        f"-path_index {tmp_path}/built.index")
    plain = ivfadc_eval.main((args.replace(f"{tmp_path}/built.index",
                                           f"{tmp_path}/plain.index")
                              + " -device cpu").split())
    res = ivfadc_eval.main((args + " -orca_obuf 1 -device cpu").split())
    assert res["stages"]["how"]["index"] == "built"
    assert res["index"].store.ntotal == 4000
    assert _bytes(tmp_path / "built.index") == _bytes(tmp_path /
                                                      "plain.index")
    np.testing.assert_array_equal(res["labels"], plain["labels"])


@pytest.mark.parametrize("ext,segments", [(".fvecs", 3), (".fvecs", 4),
                                          (".bvecs", 3)])
def test_vector_split_bytes_match_jax(corpus, tmp_path, ext, segments):
    """The port's vector_split writes the JAX tool's files, byte for byte:
    base segments {stem}_NN{ext} and one idx record per segment."""
    base = corpus["base"]
    src = tmp_path / f"base{ext}"
    if ext == ".bvecs":
        tio.write_xvec(str(src), np.clip(np.abs(base) * 20, 0,
                                         255).astype(np.uint8))
    else:
        tio.write_xvec(str(src), base)
    idxs = f"{corpus['root']}/ivfadc/idxs.ivecs"
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    written = vector_split.main(["-path_base", str(src), "-d", "32",
                                 "-segments", str(segments), "-out_dir",
                                 str(out_t), "-path_precomputed_idxs", idxs])
    old = sys.argv
    sys.argv = ["vector_split.py", "-path_base", str(src), "-d", "32",
                "-segments", str(segments), "-out_dir", str(out_j),
                "-path_precomputed_idxs", idxs]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "vector_split.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    names = sorted(os.listdir(out_j))
    assert sorted(os.listdir(out_t)) == names
    assert sorted(os.path.basename(w) for w in written) == names
    assert names == sorted([f"base_{i:02d}{ext}" for i in range(segments)]
                           + [f"idxs_{i:02d}.ivecs" for i in range(segments)])
    for name in names:
        assert _bytes(out_t / name) == _bytes(out_j / name), name


def test_vector_add_consumes_vector_split(corpus, tmp_path):
    """vector_split's segments (base and idx) through vector_add
    -segment_dir give what vector_add's own split of the same base gives:
    equal ntotal, recalls and index files."""
    root = corpus["root"]
    g = f"{root}/grouping"
    quant = (f" -path_centroids {g}/c.fvecs -path_pq {g}/x.pq"
             f" -path_norm_pq {g}/x.norm_pq -path_opq_matrix {g}/x.opq")
    common = SIZES + EXTRA["grouping"] + corpus["flags"] + quant
    seg = tmp_path / "segments"
    vector_split.split(f"{root}/base.fvecs", 32, 3, str(seg),
                       f"{g}/idxs.ivecs")
    out_s, out_o = tmp_path / "split", tmp_path / "own"
    out_s.mkdir()
    out_o.mkdir()
    rs = vector_add.main((common + f" -segment_dir {seg} -path_index "
                          f"{out_s}/index -device cpu").split())
    ro = vector_add.main((common + f" -segments 3 -path_index {out_o}/index"
                          " -device cpu").split())
    assert [r["ntotal"] for r in rs] == [r["ntotal"] for r in ro] == [
        1334, 2668, 4000]
    assert [r["recalls"] for r in rs] == [r["recalls"] for r in ro]
    for i in range(3):
        name = f"index_{i:02d}.index"
        assert _bytes(out_s / name) == _bytes(out_o / name), name
