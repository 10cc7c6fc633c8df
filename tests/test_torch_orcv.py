"""The ORCV surface of the port (ivfhnsw_tpu_torch.utils.orcv, IVFADCIndex.
write2 / add_batch2 / reseed_builder_from_store) against the JAX package, on
the CPU.

A JAX index of each kind (IVFADC d=32 nc=64, grouping d=32 nc=32 nsubc=8;
code_size 8, 6000 codes, with and without OPQ) is carried into the port
with ``from_numpy_state`` and JAX's centroid norms. Tolerances: none for
the home dir's files, except opq.vec (centroids @ R.T, a matmul whose f32
rounding differs between the packages: rtol=1e-5, divergence D10) and
under OPQ the norm code of an add_batch2 record, which may differ only at a
near-tie between two norm centroids (D3), shown by the test.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu.utils import orcv as jax_orcv
from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex, IVFADCIndex,
                               SearchParams)
from ivfhnsw_tpu_torch.utils import orcv

torch.set_num_threads(1)
CFGS = {"ivfadc": dict(d=32, nc=64, code_size=8),
        "grouping": dict(d=32, nc=32, code_size=8, nsubc=8)}
EXACT_FILES = ("hdr.vec", "cnorms.vec", "pq.vec", "normpq.vec", "edge.vec")


def _corpus(seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(40, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, 6000)] + rng.randn(6000, 32).astype(
        np.float32)
    queries = centers[rng.randint(0, 40, 20)] + rng.randn(20, 32).astype(
        np.float32)
    return base, queries


def _jax_index(kind, opq):
    base, queries = _corpus(31 if opq else 30)
    key = jax.random.PRNGKey(0)
    j = (JaxGrouping if kind == "grouping" else JaxIndex)(
        JaxConfig(do_opq=opq, **CFGS[kind]))
    j.train_centroids(key, base[:4000], niter=8)
    if kind == "grouping":
        j.compute_neighbor_centroids()
    j.train_pq(key, base[:3000], pq_niter=5, opq_niter=3)
    ids = np.arange(len(base), dtype=np.int32) * 3 + 7
    if kind == "grouping":
        j.add(base, ids)
    else:
        j.add_batch(base, ids)
    j.finalize()
    return j, base, queries


def _carry(j, kind):
    st = j.store
    common = (IndexConfig(do_opq=j.do_opq, **CFGS[kind]),
              np.asarray(j.centroids), np.asarray(j.pq.codebooks),
              np.asarray(j.norm_pq.centroids), st.codes, st.ids,
              st.norm_codes, st.list_offsets)
    opq_R = np.asarray(j.opq_R) if j.do_opq else None
    if kind == "grouping":
        t = IVFADCGroupingIndex.from_numpy_state(
            *common, np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
            np.asarray(j.inter_centroid_dists), opq_R, "cpu")
    else:
        t = IVFADCIndex.from_numpy_state(*common, "cpu", opq_R=opq_R)
    t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
    return t


_BUILT = {}


def _built(kind, opq):
    """(kind, JAX index, the port's carried index, base, queries), built
    once per module for each (kind, OPQ)."""
    if (kind, opq) not in _BUILT:
        j, base, queries = _jax_index(kind, opq)
        _BUILT[kind, opq] = kind, j, _carry(j, kind), base, queries
    return _BUILT[kind, opq]


@pytest.fixture(params=[("ivfadc", False), ("ivfadc", True),
                        ("grouping", False), ("grouping", True)],
                ids=["ivfadc-pq", "ivfadc-opq", "grouping-pq",
                     "grouping-opq"])
def built(request):
    return _built(*request.param)


@pytest.fixture(params=[False, True], ids=["ivfadc-pq", "ivfadc-opq"])
def ivf(request):
    """The IVFADC indexes alone (add_batch2 and the reseed flow are the
    IVFADC index's, as in the reference)."""
    return _built("ivfadc", request.param)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_both(j, t, tmp_path):
    hj, ht = str(tmp_path / "jax_home"), str(tmp_path / "port_home")
    j.write2(hj, n_vecs=j.store.ntotal)
    t.write2(ht, n_vecs=t.store.ntotal)
    return hj, ht


def test_header_packs_as_jax(tmp_path):
    kw = dict(n=123456, nc=4096, code_size=16, code_bytes=2, d=128, M=16,
              efConstruction=500, do_opq=1)
    raw = orcv.OrcvHeader(**kw).pack()
    assert len(raw) == 40 and raw == jax_orcv.OrcvHeader(**kw).pack()
    path = str(tmp_path / "hdr.vec")
    orcv.OrcvHeader(**kw).write(path)
    assert orcv.OrcvHeader.read(path) == orcv.OrcvHeader(**kw)
    assert orcv.OrcvHeader.read(path).dmatch == 4444.0


def test_write2_bytes_match_jax(built, tmp_path):
    kind, j, t, _, _ = built
    hj, ht = _write_both(j, t, tmp_path)
    want = set(EXACT_FILES) | ({"opq.vec"} if j.do_opq else set())
    assert set(os.listdir(ht)) == set(os.listdir(hj)) == want
    for name in EXACT_FILES:
        assert _bytes(os.path.join(ht, name)) == _bytes(
            os.path.join(hj, name)), name
    assert os.path.getsize(os.path.join(ht, "edge.vec")) == 0
    if j.do_opq:
        # D10: centroids @ R.T rounds differently; the framing is equal.
        a, b = (_bytes(os.path.join(h, "opq.vec")) for h in (ht, hj))
        assert len(a) == len(b) and a[:4] == b[:4]
        n = np.frombuffer(a[:4], "<u4")[0]
        assert n == CFGS[kind]["nc"] * 32
        np.testing.assert_allclose(np.frombuffer(a[4:], "<f4"),
                                   np.frombuffer(b[4:], "<f4"), rtol=1e-5,
                                   atol=1e-6)


def test_write2_grouping_writes_its_subgroup_lists(built, tmp_path):
    """The quirk both packages share: a grouping index's write2 writes its
    nc * nsubc subgroup lists as pq.vec / normpq.vec records under a header
    that says nc; load_home_dir then reads the first nc records only."""
    kind, j, t, _, _ = built
    _, ht = _write_both(j, t, tmp_path)
    nlists = t.store.nc
    assert nlists == (CFGS[kind]["nc"] * CFGS[kind].get("nsubc", 1))
    hdr = orcv.OrcvHeader.read(os.path.join(ht, "hdr.vec"))
    assert hdr.nc == CFGS[kind]["nc"] and hdr.n == t.store.ntotal
    raw = np.frombuffer(_bytes(os.path.join(ht, "normpq.vec")), np.uint8)
    pos, counts = 0, []
    while pos < raw.size:
        c = int(raw[pos:pos + 4].view("<u4")[0])
        counts.append(c)
        pos += 4 + c
    np.testing.assert_array_equal(counts, np.diff(t.store.list_offsets))
    assert len(counts) == nlists
    r, _ = orcv.load_home_dir(ht, "cpu")
    first = int(t.store.list_offsets[hdr.nc])
    np.testing.assert_array_equal(r.store.norm_codes,
                                  t.store.norm_codes[:first])
    np.testing.assert_array_equal(r.store.list_offsets,
                                  t.store.list_offsets[:hdr.nc + 1])


def _same_store(a, b, ids=True):
    names = ("codes", "norm_codes", "list_offsets") + (("ids",) if ids
                                                      else ())
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


def test_load_home_dir_crosses_the_packages(built, tmp_path):
    """Each package's load_home_dir reads the other's dir into the store its
    own loader makes of its own dir: ids in insertion order."""
    kind, j, t, _, _ = built
    hj, ht = _write_both(j, t, tmp_path)
    pj, hdr_j = jax_orcv.load_home_dir(hj)
    pt, hdr_t = orcv.load_home_dir(ht, "cpu")
    xj, _ = jax_orcv.load_home_dir(ht)
    xt, _ = orcv.load_home_dir(hj, "cpu")
    assert hdr_t == orcv.OrcvHeader(**vars(hdr_j))
    _same_store(xt.store, pj.store)
    _same_store(xj.store, pt.store)
    _same_store(pt.store, pj.store)
    np.testing.assert_array_equal(pt.store.ids,
                                  np.arange(pt.store.ntotal, dtype=np.int32))
    np.testing.assert_array_equal(pt.centroid_norms.numpy(),
                                  np.asarray(pj.centroid_norms))
    assert pt.config.do_opq == j.do_opq and pt.config.nc == CFGS[kind]["nc"]


def test_loaded_home_dir_searches_as_the_original(ivf, tmp_path):
    """An IVFADC index reloaded from its home dir (with its centroids and
    quantizers) gives the original's distances bit for bit, and its labels
    through the original store's ids."""
    kind, _, t, _, queries = ivf
    home = str(tmp_path / "home")
    t.write2(home, n_vecs=t.store.ntotal)
    r, _ = orcv.load_home_dir(home, "cpu")
    r.set_centroids(t.centroids)
    r.centroid_norms = t.centroid_norms
    r.pq, r.norm_pq, r.opq_R = t.pq, t.norm_pq, t.opq_R
    for engine, layout in (("torch", "auto"), ("fused", "chunk"),
                           ("fused", "quad")):
        t.engine = r.engine = engine
        t.scan_layout = r.scan_layout = layout
        p = SearchParams(k=10, nprobe=8, max_codes=400)
        d1, l1 = t.search(queries, p)
        d2, l2 = r.search(queries, p)
        np.testing.assert_array_equal(d2, d1)
        np.testing.assert_array_equal(t.store.ids[l2], l1)
    t.engine = t.scan_layout = "auto"


def test_load_home_dir_takes_a_centroids_file(built, tmp_path):
    kind, _, t, _, _ = built
    from ivfhnsw_tpu_torch.utils import io
    home, cpath = str(tmp_path / "home"), str(tmp_path / "c.fvecs")
    t.write2(home, n_vecs=t.store.ntotal)
    io.write_xvec(cpath, t.centroids.numpy())
    r, _ = orcv.load_home_dir(home, "cpu", centroids_path=cpath)
    np.testing.assert_array_equal(r.centroids.numpy(), t.centroids.numpy())
    # the file's norms replace the ones computed from the centroids
    np.testing.assert_array_equal(r.centroid_norms.numpy(),
                                  t.centroid_norms.numpy())


def _rec(buf, pq_m):
    return np.frombuffer(buf, dtype=[("eid", "<u8"), ("code", "u1", (pq_m,)),
                                     ("norm", "u1")])


def test_add_batch2_obuf_matches_jax(ivf):
    kind, j, t, base, _ = ivf
    n, pq_m = 700, CFGS[kind]["code_size"]
    keys = j.assign(base[:n])
    eids = np.arange(n, dtype=np.uint64) * 11 + 2**40
    xids = np.arange(n, dtype=np.int32)
    fj, ft = JaxIndex(j.config), IVFADCIndex(t.config, "cpu")
    fj.set_centroids(np.asarray(j.centroids))
    fj.pq, fj.norm_pq, fj.opq_R = j.pq, j.norm_pq, j.opq_R
    ft.set_centroids(t.centroids)
    ft.pq, ft.norm_pq, ft.opq_R = t.pq, t.norm_pq, t.opq_R
    bj = fj.add_batch2(base[:n], xids, keys, eids)
    bt = ft.add_batch2(base[:n], xids, keys, eids)
    assert len(bt) == len(bj) == n * (8 + pq_m + 1)
    rj, rt = _rec(bj, pq_m), _rec(bt, pq_m)
    np.testing.assert_array_equal(rt["eid"], eids)
    np.testing.assert_array_equal(rt["code"], rj["code"])
    diff = np.nonzero(rt["norm"] != rj["norm"])[0]
    if not j.do_opq:
        assert bt == bj
    cents = np.asarray(j.norm_pq.centroids, np.float64)
    cb = np.asarray(j.pq.codebooks, np.float64)
    for r in diff:      # D3 near-ties under OPQ only, each shown
        dec = cb[np.arange(cb.shape[0]), rj["code"][r]].reshape(-1)
        rec = dec @ np.asarray(j.opq_R, np.float64) + np.asarray(
            j.centroids, np.float64)[keys[r]]
        nrm = float(rec @ rec)
        assert abs(abs(nrm - cents[rt["norm"][r]])
                   - abs(nrm - cents[rj["norm"][r]])) <= 1e-5 * nrm
    # the records also went into the index, as add_batch would put them
    ft.finalize()
    fa = IVFADCIndex(t.config, "cpu")
    fa.set_centroids(t.centroids)
    fa.pq, fa.norm_pq, fa.opq_R = t.pq, t.norm_pq, t.opq_R
    fa.add_batch(base[:n], xids, keys)
    fa.finalize()
    _same_store(ft.store, fa.store)
    assert ft.builder.ntotal == n


def test_read_reseed_add_equals_a_one_shot_build(ivf, tmp_path):
    """JAX's flow (tests/test_ivfadc.py:246-285) on the port: write half,
    read it back (read seeds the builder), reseed (rebuilds, not doubles),
    add the second half: byte-identical to a one-shot build."""
    kind, _, t, base, _ = ivf
    half = len(base) // 2
    keys = t.assign(base)

    def fresh():
        r = IVFADCIndex(t.config, "cpu")
        r.set_centroids(t.centroids)
        r.pq, r.norm_pq, r.opq_R = t.pq, t.norm_pq, t.opq_R
        return r

    a = fresh()
    a.add_batch(base[:half], np.arange(half, dtype=np.int32), keys[:half])
    a.finalize()
    p = str(tmp_path / "half.index")
    a.write(p)
    b = fresh()
    b.read(p)
    assert b.builder.ntotal == half
    b.reseed_builder_from_store()
    assert b.builder.ntotal == half         # rebuilt, not added twice
    b.store = None
    b.add_batch(base[half:], np.arange(half, len(base), dtype=np.int32),
                keys[half:])
    b.finalize()
    full = fresh()
    full.add_batch(base, np.arange(len(base), dtype=np.int32), keys)
    full.finalize()
    assert b.store.ntotal == full.store.ntotal == len(base)
    _same_store(b.store, full.store)
    pb, pf = str(tmp_path / "b.index"), str(tmp_path / "full.index")
    b.write(pb)
    full.write(pf)
    assert _bytes(pb) == _bytes(pf)
