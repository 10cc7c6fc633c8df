"""The port's sharded search (ivfhnsw_tpu_torch/parallel/sharded.py,
sharded_grouping.py) against the JAX package's (ivfhnsw_tpu/parallel/) on
the CPU, mirroring tests/test_sharded.py.

JAX indexes (IVFADC d=32 nc=64 code_size 8 over 12000 clustered vectors,
with and without OPQ; grouping nc=32 nsubc=4 over 10000) are carried into
the port with ``from_numpy_state`` and JAX's centroid norms. The JAX
references run on the 8 virtual CPU devices of tests/conftest.py; the
port's shards are a ``LocalShards`` group of D shards on the CPU. Tolerance:
the cross-engine contract (rtol=1e-4, atol=1e-3; labels differ only where
distances tie) against JAX's "xla" and "pallas_interpret" sharded engines
and against the port's single index (exact coarse selection).
"""

import jax
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.parallel import ShardedIVFADC as JaxSharded
from ivfhnsw_tpu.parallel import make_mesh as jax_mesh
from ivfhnsw_tpu.parallel.sharded_grouping import \
    ShardedGrouping as JaxShardedGrouping
from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex, IVFADCIndex,
                               SearchParams)
from ivfhnsw_tpu_torch.ops.grouping import group_terms, pruning_sums
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.parallel import (DistributedShards, LocalShards,
                                        ShardedGrouping, ShardedIVFADC,
                                        make_mesh)

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
_BUILT = {}


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


def local(D):
    return LocalShards(["cpu"] * D)


def carry_ivfadc(j, store=None):
    """The port's index of JAX index ``j``'s state (its centroid norms
    too), with ``store`` = (codes, ids, norm_codes, offsets) in place of
    j's when given."""
    st = j.store
    store = store or (st.codes, st.ids, st.norm_codes, st.list_offsets)
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=j.d, nc=j.nc, code_size=j.config.code_size,
                    do_opq=j.do_opq),
        np.asarray(j.centroids), np.asarray(j.pq.codebooks),
        np.asarray(j.norm_pq.centroids), *store, "cpu",
        opq_R=np.asarray(j.opq_R) if j.do_opq else None)
    t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
    return t


def built(opq):
    """(JAX IVFADC index, the port's carried index, queries), once."""
    if ("ivfadc", opq) not in _BUILT:
        rng = np.random.RandomState(5)
        nb, d = 12000, 32
        centers = rng.randn(48, d).astype(np.float32) * 5
        base = (centers[rng.randint(0, 48, nb)]
                + rng.randn(nb, d).astype(np.float32))
        queries = (centers[rng.randint(0, 48, 32)]
                   + rng.randn(32, d).astype(np.float32))
        j = JaxIndex(JaxConfig(d=d, nc=64, code_size=8, do_opq=opq))
        key = jax.random.PRNGKey(0)
        j.train_centroids(key, base[:4000], niter=12)
        j.train_pq(key, base[:4000], opq_niter=4)
        j.add_batch(base, np.arange(nb, dtype=np.int32))
        j.finalize()
        _BUILT["ivfadc", opq] = j, carry_ivfadc(j), queries
    return _BUILT["ivfadc", opq]


def built_grouping():
    if "grouping" not in _BUILT:
        rng = np.random.RandomState(6)
        nb, d = 10000, 32
        centers = rng.randn(40, d).astype(np.float32) * 5
        base = (centers[rng.randint(0, 40, nb)]
                + rng.randn(nb, d).astype(np.float32))
        queries = (centers[rng.randint(0, 40, 24)]
                   + rng.randn(24, d).astype(np.float32))
        cfg = dict(d=d, nc=32, code_size=8, nsubc=4)
        j = JaxGrouping(JaxConfig(**cfg))
        key = jax.random.PRNGKey(0)
        j.train_centroids(key, base[:4000], niter=10)
        j.compute_neighbor_centroids()
        j.train_pq(key, base[:3000])
        j.add(base, np.arange(nb, dtype=np.int32))
        j.finalize()
        st = j.store
        t = IVFADCGroupingIndex.from_numpy_state(
            IndexConfig(**cfg), np.asarray(j.centroids),
            np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
            st.codes, st.ids, st.norm_codes, st.list_offsets,
            np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
            np.asarray(j.inter_centroid_dists), None, "cpu")
        t.centroid_norms = torch.from_numpy(np.array(j.centroid_norms))
        _BUILT["grouping"] = j, t, queries
    return _BUILT["grouping"]


def single(t, queries, p):
    """The port's single index, torch engine (exact coarse)."""
    t.engine = "torch"
    try:
        return t.search(queries, SearchParams(**p))
    finally:
        t.engine = "auto"


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
@pytest.mark.parametrize("max_codes", [0, 500])
@pytest.mark.parametrize("D", [2, 8])
def test_sharded_ivfadc_matches_jax_and_single(D, max_codes, opq):
    j, t, queries = built(opq)
    p = dict(k=10, nprobe=8, max_codes=max_codes)
    dj, lj = JaxSharded(j, jax_mesh(D)).search(queries, JaxParams(**p),
                                               engine="xla")
    ds, ls = single(t, queries, p)
    sh = ShardedIVFADC(t, local(D))
    for engine in ("torch", "fused"):
        d, l = sh.search(queries, SearchParams(**p), engine=engine)
        assert d.shape == (len(queries), 10) and l.dtype == np.int64
        assert_same(np.asarray(dj), np.asarray(lj), d, l)
        assert_same(ds, ls, d, l)
    assert sorted(sh.last_slots) == list(range(D))


@pytest.mark.parametrize("layout,topk", [("chunk", "wide"), ("quad", "wide"),
                                         ("chunk", "twophase"),
                                         ("quad", "twophase")])
def test_fused_layouts_match_the_torch_engine(layout, topk):
    """The fused engine at both slot widths, wide and two-phase (the
    scan kernels' plain versions on the CPU), against the torch engine;
    each shard's slots are its own demand."""
    _, t, queries = built(False)
    t.scan_layout, t.scan_topk = layout, topk
    try:
        sh = ShardedIVFADC(t, local(4))
    finally:
        t.scan_layout = t.scan_topk = "auto"
    p = SearchParams(k=10, nprobe=16, max_codes=500)
    d0, l0 = sh.search(queries, p, engine="torch")
    d1, l1 = sh.search(queries, p, engine="fused")
    assert_same(d0, l0, d1, l1)
    gran = sh.scan_gran()
    assert gran == (1024 if layout == "quad" else 256)
    for s in range(4):
        args = sh.scan_inputs(queries, p, s)
        start, length = args[4], args[5]
        # the demand: the fullest query fills its last slot, none overflows
        assert start.shape[1] == sh.last_slots[s]
        assert int((length > 0).sum(1).max()) == start.shape[1]


def test_rejects_a_partition_that_does_not_divide_nc():
    _, t, _ = built(False)
    with pytest.raises(ValueError, match="divide"):
        ShardedIVFADC(t, local(3))                   # 64 % 3 != 0
    _, g, _ = built_grouping()
    with pytest.raises(ValueError, match="divide"):
        ShardedGrouping(g, local(3))


def test_rejects_inexact_coarse_modes_and_unknown_engines():
    _, t, queries = built(False)
    sh = ShardedIVFADC(t, local(2))
    for mode in ("approx", "routed", "binned"):
        with pytest.raises(ValueError, match="exactly"):
            sh.search(queries, SearchParams(k=10, nprobe=8,
                                            coarse_mode=mode))
    with pytest.raises(ValueError, match="engine"):
        sh.search(queries, SearchParams(k=10, nprobe=8), engine="xla")


def test_a_tensor_on_another_device_than_its_shard_raises():
    """The group's collectives refuse a part that is not on its shard's
    device; a distributed group refuses a device its backend cannot
    serve (no NCCL in the default group here: no process group at all)."""
    g = LocalShards(["cpu", "meta"])
    with pytest.raises(ValueError, match="its shard is on meta"):
        g.psum([torch.zeros(2), torch.zeros(2)])
    with pytest.raises(ValueError, match="its shard is on meta"):
        g.all_gather([torch.zeros(2), torch.zeros(2)])
    with pytest.raises(RuntimeError, match="process group"):
        DistributedShards("cpu")
    with pytest.raises(ValueError, match="need 3 devices"):
        make_mesh(3, devices=["cpu", "cpu"])
    assert make_mesh(2, devices=["cpu"] * 4).size == 2


def test_empty_shards_take_part_and_return_nothing():
    """Shards 2 and 3 of 4 hold no codes (every vector sits in the first
    half of the lists): they still take part in every collective, return
    +inf / -1, and the merged result equals the single index's and JAX's
    sharded search over the same store."""
    j, _, queries = built(False)
    st = j.store
    half = int(st.list_offsets[j.nc // 2])
    off = np.minimum(np.asarray(st.list_offsets), half)
    store = (st.codes[:half], st.ids[:half], st.norm_codes[:half], off)
    t = carry_ivfadc(j, store)
    p = dict(k=10, nprobe=8, max_codes=0)
    ds, ls = single(t, queries, p)
    sh = ShardedIVFADC(t, local(4))
    assert [s.store.ntotal for s in sh.shards[2:]] == [0, 0]
    for engine in ("torch", "fused"):
        d, l = sh.search(queries, SearchParams(**p), engine=engine)
        assert_same(ds, ls, d, l)
        assert sh.last_slots[2] == sh.last_slots[3] == 0
    # JAX's sharded search over the same store
    from ivfhnsw_tpu.models.storage import PostingListStore as JaxStore
    j2 = JaxIndex(j.config)
    j2.set_centroids(np.asarray(j.centroids))
    j2.pq, j2.norm_pq = j.pq, j.norm_pq
    j2.store = JaxStore(codes=store[0], ids=store[1], norm_codes=store[2],
                        list_offsets=store[3].astype(np.int32), nc=j.nc)
    dj, lj = JaxSharded(j2, jax_mesh(4)).search(queries, JaxParams(**p),
                                                engine="xla")
    assert_same(np.asarray(dj), np.asarray(lj), d, l)


@pytest.mark.parametrize("D,pruning", [(4, False), (4, True), (8, False),
                                       (8, True)])
def test_sharded_grouping_matches_jax_and_single(D, pruning):
    j, t, queries = built_grouping()
    p = dict(k=10, nprobe=8, max_codes=800, do_pruning=pruning)
    dj, lj = JaxShardedGrouping(j, jax_mesh(D)).search(
        queries, JaxParams(**p), engine="xla")
    ds, ls = single(t, queries, p)
    sh = ShardedGrouping(t, local(D))
    for engine in ("torch", "fused"):
        d, l = sh.search(queries, SearchParams(**p), engine=engine)
        assert_same(np.asarray(dj), np.asarray(lj), d, l)
        assert_same(ds, ls, d, l)
    for s in range(D):      # each shard's kernel arguments, as searched
        args = sh.scan_inputs(queries, SearchParams(**p), s)
        assert (0 if args is None else args[6].shape[1]) == sh.last_slots[s]


@pytest.mark.parametrize("pruning", [False, True])
def test_sharded_grouping_fused_matches_jax_pallas(pruning):
    """The port's fused sharded grouping engine (the grouping kernel's
    plain version on the CPU) against JAX's sharded grouping kernel in
    Pallas interpret mode, on 8 queries (interpret mode runs a grid step
    per query and slot block)."""
    j, t, queries = built_grouping()
    q = queries[:8]
    p = dict(k=10, nprobe=8, max_codes=800, do_pruning=pruning)
    dj, lj = JaxShardedGrouping(j, jax_mesh(4)).search(
        q, JaxParams(**p), engine="pallas_interpret")
    for layout in ("chunk", "quad"):
        t.scan_layout = layout
        try:
            sh = ShardedGrouping(t, local(4))
        finally:
            t.scan_layout = "auto"
        d, l = sh.search(q, SearchParams(**p), engine="fused")
        assert_same(np.asarray(dj), np.asarray(lj), d, l)


def test_pruning_flips_lie_at_the_threshold():
    """The threshold's f32 sum over 8 shards is taken in shard order: a
    subgroup whose pruning decision differs from the single index's lies
    at the threshold (D3), and the counts are equal."""
    _, t, queries = built_grouping()
    q = torch.from_numpy(queries)
    qc, probes = streaming_topk_l2(q, t.centroids, 8,
                                   point_sqnorms=t.centroid_norms)
    gv = t._grouped()
    _, _, qsd, ssz = group_terms(q, qc, probes, t.centroids,
                                 t.centroid_norms, t.nn_centroid_idxs,
                                 t.alphas, t.inter_centroid_dists,
                                 gv.sub_sizes_t, True)
    gsz = ssz.sum(dim=2)
    total, count = pruning_sums(qsd, ssz, gsz, 800)
    nc_loc = t.nc // 8
    parts = [pruning_sums(qsd, torch.where(
        (probes // nc_loc == s)[:, :, None], ssz, 0), gsz, 800)
        for s in range(8)]
    s_total = parts[0][0]
    for part in parts[1:]:
        s_total = s_total + part[0]
    assert torch.equal(sum(pt[1] for pt in parts), count)
    thr, s_thr = total / count.clamp_min(1), s_total / count.clamp_min(1)
    torch.testing.assert_close(s_thr, thr, rtol=1e-6, atol=0)
    flip = (ssz > 0) & ((qsd < thr[:, None, None])
                        != (qsd < s_thr[:, None, None]))
    gap = (qsd - thr[:, None, None]).abs()
    assert bool((gap[flip] <= (s_thr - thr).abs().max() + 1e-6).all())
