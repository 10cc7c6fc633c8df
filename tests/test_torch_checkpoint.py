"""The port's checkpoint directory (ivfhnsw_tpu_torch.utils.checkpoint) against
the JAX package's (ivfhnsw_tpu/utils/checkpoint.py), on the CPU, mirroring
tests/test_checkpoint.py:29-62.

JAX indexes of both kinds, with and without OPQ (IVFADC d=16 nc=32
code_size 4, grouping nsubc 4; 6000 codes) are carried into the port with
``from_numpy_state`` and JAX's centroid norms. Tolerances: none within a
package (a loaded index searches as the saved one, bit for bit); across the
packages the manifest and every array are equal, and a checkpoint written
by either loads in the other and searches to the cross-engine contract
(rtol=1e-4, atol=1e-3, labels differ only where distances tie), JAX on
"xla" and the port on "torch".
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.utils import checkpoint as jax_checkpoint
from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex, IVFADCIndex,
                               SearchParams)
from ivfhnsw_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3

_BUILT = {}


def _built(grouping, opq):
    """(JAX index, the port's carried index, queries), once per module."""
    if (grouping, opq) in _BUILT:
        return _BUILT[grouping, opq]
    rng = np.random.RandomState(42 + 2 * grouping + opq)
    nb, d = 6000, 16
    base = rng.randn(nb, d).astype(np.float32)
    queries = rng.randn(16, d).astype(np.float32)
    cfg = dict(d=d, nc=32, code_size=4, nsubc=4 if grouping else 0,
               do_opq=opq)
    j = (JaxGrouping if grouping else JaxIndex)(JaxConfig(**cfg))
    key = jax.random.PRNGKey(0)
    j.train_centroids(key, base[:3000], niter=8)
    if grouping:
        j.compute_neighbor_centroids()
    j.train_pq(key, base[:2000], opq_niter=4)
    if grouping:
        j.add(base, np.arange(nb, dtype=np.int32))
    else:
        j.add_batch(base, np.arange(nb, dtype=np.int32))
    j.finalize()
    st = j.store
    common = (IndexConfig(**cfg), np.asarray(j.centroids),
              np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
              st.codes, st.ids, st.norm_codes, st.list_offsets)
    opq_R = np.asarray(j.opq_R) if opq else None
    if grouping:
        t = IVFADCGroupingIndex.from_numpy_state(
            *common, np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
            np.asarray(j.inter_centroid_dists), opq_R, "cpu")
    else:
        t = IVFADCIndex.from_numpy_state(*common, "cpu", opq_R=opq_R)
    t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
    _BUILT[grouping, opq] = j, t, queries
    return _BUILT[grouping, opq]


@pytest.fixture(params=[(False, False), (False, True), (True, False),
                        (True, True)],
                ids=["ivfadc-pq", "ivfadc-opq", "grouping-pq",
                     "grouping-opq"])
def built(request):
    return _built(*request.param)


def _params(t):
    return dict(k=10, nprobe=8, max_codes=0,
                do_pruning=isinstance(t, IVFADCGroupingIndex))


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


def _search_jax(j, queries, p):
    j.engine = "xla"
    try:
        return tuple(np.asarray(a) for a in j.search(queries, JaxParams(**p)))
    finally:
        j.engine = "auto"


def test_roundtrip_searches_bit_equal(built, tmp_path):
    _, t, queries = built
    path = str(tmp_path / "ckpt")
    checkpoint.save_index(t, path)
    r = checkpoint.load_index(path, "cpu")
    assert type(r) is type(t) and r.device == torch.device("cpu")
    assert r.builder.ntotal == t.store.ntotal   # seeded, as read seeds it
    for engine, layout in (("torch", "auto"), ("fused", "chunk"),
                           ("fused", "quad")):
        t.engine = r.engine = engine
        t.scan_layout = r.scan_layout = layout
        d1, l1 = t.search(queries, SearchParams(**_params(t)))
        d2, l2 = r.search(queries, SearchParams(**_params(t)))
        np.testing.assert_array_equal(d2, d1)
        np.testing.assert_array_equal(l2, l1)
    t.engine = t.scan_layout = "auto"


def test_files_match_jax(built, tmp_path):
    j, t, _ = built
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jax_checkpoint.save_index(j, pj)
    checkpoint.save_index(t, pt)
    assert sorted(os.listdir(pt)) == sorted(os.listdir(pj))
    with open(os.path.join(pt, "manifest.json")) as f:
        mt = json.load(f)
    with open(os.path.join(pj, "manifest.json")) as f:
        mj = json.load(f)
    assert mt == mj and mt["format"] == "ivfhnsw_tpu.checkpoint.v1"
    for name in mt["arrays"]:
        a = np.load(os.path.join(pt, f"{name}.npy"))
        b = np.load(os.path.join(pj, f"{name}.npy"))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_port_loads_a_jax_checkpoint(built, tmp_path):
    j, _, queries = built
    path = str(tmp_path / "j")
    jax_checkpoint.save_index(j, path)
    r = checkpoint.load_index(path, "cpu")
    p = _params(r)
    r.engine = "torch"
    d2, l2 = r.search(queries, SearchParams(**p))
    assert_same(*_search_jax(j, queries, p), d2, l2)
    np.testing.assert_array_equal(r.centroid_norms.numpy(),
                                  np.asarray(j.centroid_norms))


def test_jax_loads_a_port_checkpoint(built, tmp_path):
    j, t, queries = built
    path = str(tmp_path / "t")
    checkpoint.save_index(t, path)
    r = jax_checkpoint.load_index(path)
    assert isinstance(r, JaxGrouping) == isinstance(t, IVFADCGroupingIndex)
    p = _params(t)
    t.engine = "torch"
    d1, l1 = t.search(queries, SearchParams(**p))
    t.engine = "auto"
    assert_same(d1, l1, *_search_jax(r, queries, p))


def test_rejects_an_unknown_format(tmp_path):
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "manifest.json").write_text(
        json.dumps({"format": "nope"}))
    with pytest.raises(ValueError):
        checkpoint.load_index(str(tmp_path / "bad"), "cpu")
