"""The port's shard-streamed 1B search (ivfhnsw_tpu_torch/tools/search_1b.py:
assemble_shard, shard_probes, IVFShard.scan on the torch engine,
merge_topk) against the JAX tool's composition (tests/test_search1b_math.py:
38-95, through JAX's search_precomputed), on one store carried across as
numpy and the JAX coarse step's probes, at S in {1, 4}.

Both packages count ``max_codes`` over each shard's own probes
(tools/search_1b.py:174-178). With a budget that never binds, both equal
the single-store search. With one that binds, the port equals JAX's
composition; at S=4 both differ from the single store and scan more codes,
at S=1 both equal it. Tolerance rtol=1e-4, atol=1e-3; labels may differ
only at equal distances (tests/test_pallas_adc.py:42-46)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.models.storage import PostingListStore as JaxStore
from ivfhnsw_tpu.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.models.storage import PostingListBuilder
from ivfhnsw_tpu_torch.tools import search_1b

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
NPROBE, K = 12, 10
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def built():
    rng = np.random.RandomState(5)
    nb, d, nc = 20000, 32, 64
    centers = rng.randn(96, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 96, nb)] + rng.randn(nb, d).astype(
        np.float32)
    queries = centers[rng.randint(0, 96, 32)] + rng.randn(32, d).astype(
        np.float32)
    # and 32 between two clusters, whose neighbours spread over lists
    a, b = rng.randint(0, 96, (2, 32))
    queries = np.vstack([queries, (centers[a] + centers[b]) / 2
                         + rng.randn(32, d).astype(np.float32)])
    idx = JaxIndex(JaxConfig(d=d, nc=nc, code_size=8))
    key = jax.random.PRNGKey(0)
    idx.train_centroids(key, base[:8000], niter=12)
    idx.train_pq(key, base[:6000])
    idx.add_batch(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    qc, probes = streaming_topk_l2(
        jnp.asarray(queries), idx.centroids, NPROBE, block=idx._cb(),
        point_sqnorms=idx.centroid_norms,
        precision=jax.lax.Precision.HIGHEST)
    st = idx.store
    store = {n: np.asarray(getattr(st, n))
             for n in ("codes", "ids", "norm_codes", "list_offsets")}
    proto = IVFADCIndex(IndexConfig(d=d, nc=nc, code_size=8), CPU)
    proto.set_centroids(np.asarray(idx.centroids))
    proto.pq.codebooks = torch.tensor(np.asarray(idx.pq.codebooks))
    proto.norm_pq.centroids = torch.tensor(np.asarray(idx.norm_pq.centroids))
    return idx, proto, queries, np.asarray(qc), np.asarray(probes), store


def _sp(idx, mc):
    mx = int(np.diff(np.asarray(idx.store.list_offsets)).max())
    return JaxParams(k=K, nprobe=NPROBE, max_codes=mc,
                     scan_budget=-(-(mc + mx) // 128) * 128)


def _budget_codes(sizes, mc):
    """Codes of the lists a max_codes budget admits, per query."""
    before = np.cumsum(sizes, 1) - sizes
    return np.where(before < mc, sizes, 0).sum(1)


def jax_composition(built, S, mc):
    """tests/test_search1b_math.py's steps: per shard a JAX index over the
    range's lists plus an empty pad list, the probes masked to the shard in
    global order (pads +inf), search_precomputed, a lexsort merge. Also
    the codes each query scans."""
    idx, _, queries, qc, probes, store = built
    nc, d = idx.nc, idx.d
    nq = queries.shape[0]
    offs = store["list_offsets"].astype(np.int64)
    sizes_g = np.diff(offs)
    keys_flat = np.repeat(np.arange(nc), sizes_g)
    cents = np.asarray(idx.centroids)
    all_d = np.full((nq, S * K), np.inf, np.float32)
    all_l = np.full((nq, S * K), -1, np.int64)
    codes = np.zeros(nq, np.int64)
    nc_per = -(-nc // S)
    for s in range(S):
        lo, hi = s * nc_per, min((s + 1) * nc_per, nc)
        nc_loc = hi - lo
        sel = np.flatnonzero((keys_flat >= lo) & (keys_flat < hi))
        soffs = np.zeros(nc_loc + 2, np.int64)
        np.cumsum(np.bincount(keys_flat[sel] - lo, minlength=nc_loc + 1),
                  out=soffs[1:])
        sidx = JaxIndex(JaxConfig(d=d, nc=nc_loc + 1, code_size=8))
        sidx.set_centroids(np.vstack([cents[lo:hi],
                                      np.zeros((1, d), np.float32)]))
        sidx.pq, sidx.norm_pq = idx.pq, idx.norm_pq
        sidx.store = JaxStore(
            codes=store["codes"][sel], ids=store["ids"][sel],
            norm_codes=store["norm_codes"][sel],
            list_offsets=soffs.astype(np.int32), nc=nc_loc + 1)
        m = (probes >= lo) & (probes < hi)
        order = np.argsort(~m, axis=1, kind="stable")
        p_sh = (np.take_along_axis(probes, order, 1) - lo).astype(np.int32)
        d_sh = np.take_along_axis(qc, order, 1).astype(np.float32)
        msk = np.take_along_axis(m, order, 1)
        p_sh[~msk] = nc_loc
        d_sh[~msk] = np.inf
        d_o, l_o = sidx.search_precomputed(queries, p_sh, d_sh, _sp(idx, mc))
        all_d[:, s * K:(s + 1) * K] = d_o
        all_l[:, s * K:(s + 1) * K] = l_o
        codes += _budget_codes(np.where(msk, np.diff(soffs)[p_sh], 0), mc)
    return (*search_1b.merge_topk(all_d, all_l, K), codes)


def port_composition(built, S, mc):
    """search_1b.py's steps on the CPU, engine "torch": each shard's store
    assembled from the store's arrays as a spill (in steps of 4096 rows),
    its probes and budget, its scan, the merge; and the codes each query
    scans."""
    _, proto, queries, qc, probes, store = built
    offs = store["list_offsets"].astype(np.int64)
    spill = search_1b.Spill(np.repeat(np.arange(proto.nc, dtype=np.int32),
                                      np.diff(offs)),
                            store["ids"], store["codes"],
                            store["norm_codes"])
    q, p_t, qc_t = (torch.tensor(a) for a in (queries, probes, qc))
    p_t = p_t.long()
    nq, nc = queries.shape[0], proto.nc
    all_d = np.full((nq, S * K), np.inf, np.float32)
    all_l = np.full((nq, S * K), -1, np.int64)
    codes = torch.zeros(nq, dtype=torch.int64)
    nc_per = -(-nc // S)
    for s in range(S):
        lo, hi = s * nc_per, min((s + 1) * nc_per, nc)
        shard = search_1b.make_shard(
            proto, search_1b.assemble_shard(spill, lo, hi, CPU, rows=4096),
            s, lo)
        inc, term1, sizes = search_1b.shard_probes(shard, p_t, qc_t, mc)
        d, lab, _ = shard.scan(q, p_t, inc, term1, K, "torch", 256, False,
                               None)
        all_d[:, s * K:(s + 1) * K] = d.numpy()
        all_l[:, s * K:(s + 1) * K] = lab.numpy()
        codes += torch.where(inc, sizes, 0).sum(1)
    return (*search_1b.merge_topk(all_d, all_l, K), codes.numpy())


def _same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():       # equal-distance labels may swap
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("mc,binds", [(10_000, False), (500, True)])
def test_port_shard_composition_equals_jax(built, S, mc, binds):
    idx, _, queries, qc, probes, store = built
    jd, jl, jcodes = jax_composition(built, S, mc)
    td, tl, tcodes = port_composition(built, S, mc)
    _same(jd, jl, td, tl)
    np.testing.assert_array_equal(tcodes, jcodes)
    # the single store, explicit probes (search2)
    d_ref, l_ref = idx.search_precomputed(queries, probes, qc, _sp(idx, mc))
    single = _budget_codes(np.diff(store["list_offsets"].astype(
        np.int64))[probes], mc)
    assert binds == bool((single < np.diff(store["list_offsets"]
                                           ).astype(np.int64)[probes].sum(1)
                          ).any())
    if S == 1 or not binds:
        _same(d_ref, l_ref, td, tl)
        _same(d_ref, l_ref, jd, jl)
        np.testing.assert_array_equal(tcodes, single)
    else:
        # each shard spends its own budget: more codes, other results
        assert (tcodes >= single).all() and tcodes.mean() > single.mean()
        for d in (td, jd):
            assert not np.allclose(d, d_ref, rtol=RTOL, atol=ATOL)
            assert (d <= d_ref + ATOL + RTOL * np.abs(d_ref)).all()


def test_assemble_shard_equals_posting_list_builder():
    """A shuffled spill: each range's store equals PostingListBuilder's
    over the same rows (its stable sort by key), at any step size."""
    rng = np.random.RandomState(7)
    n, nc, M = 5000, 37, 8
    spill = search_1b.Spill(rng.randint(0, nc, n).astype(np.int32),
                            rng.permutation(n).astype(np.int32),
                            rng.randint(0, 256, (n, M)).astype(np.uint8),
                            rng.randint(0, 256, n).astype(np.uint8))
    for lo, hi, rows in ((0, nc, 1 << 20), (5, 20, 333), (20, 37, 64),
                         (36, 37, 1000)):
        got = search_1b.assemble_shard(spill, lo, hi, CPU, rows=rows)
        m = (spill.keys >= lo) & (spill.keys < hi)
        b = PostingListBuilder(hi - lo, M)
        b.add(spill.keys[m] - lo, spill.ids[m], spill.codes[m],
              spill.norm_codes[m])
        want = b.finalize(CPU)
        for name in ("codes", "ids", "norm_codes", "list_offsets"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.list_offsets_t.dtype == torch.int64
        assert torch.equal(got.codes_t, torch.from_numpy(want.codes))
