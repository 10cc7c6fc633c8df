"""The PyTorch port's Grouping+Pruning slice (ivfhnsw_tpu_torch.models.
grouping, ops.grouping, ops.cuda.grouping_scan's schedule and its driver)
against the JAX package, on the CPU.

A JAX grouping index is built and carried across with
``from_numpy_state``; the port's ``search`` (engine "torch", and engine
"fused" at both slot widths) must match JAX's "xla" engine within the
cross-engine contract of tests/test_grouping_pallas.py:38-42 (rtol=1e-4,
atol=1e-3; labels may differ only where distances tie), with max_codes
off, binding, and with pruning, and with OPQ. The JAX "pallas_interpret"
references are in tests/test_torch_grouping_pallas.py.

Other tolerances: alpha statistics and alphas rtol 1e-5 (f32 sums in
another order), beyond that only by what points at a near-tie between two
candidate directions can move (computed by the test); neighbour distances
rtol 1e-5, atol 1e-4; integer outputs (neighbour ids, store arrays,
schedules) bit-equal, and subcentroid ids bit-equal except at a near-tie
that the test shows.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCGroupingIndex as JaxGrouping
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.models import grouping as jg
from ivfhnsw_tpu_torch import IndexConfig, IVFADCGroupingIndex, SearchParams
from ivfhnsw_tpu_torch.drivers import grouping_eval
from ivfhnsw_tpu_torch.models import grouping as tg
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tgs

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(d=32, nc=32, code_size=8, nsubc=8)
PARAMS = {"mc0": dict(k=10, nprobe=6, max_codes=0),
          "mc400": dict(k=10, nprobe=8, max_codes=400),
          "prune": dict(k=10, nprobe=8, max_codes=600, do_pruning=True)}


def _jax_index(seed, opq):
    """A JAX grouping index as tests/test_grouping_pallas.py builds it."""
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
    j.add(base, np.arange(nb, dtype=np.int32))
    j.finalize()
    return j, base, queries


@pytest.fixture(scope="module")
def built():
    return _jax_index(13, opq=False)


@pytest.fixture(scope="module")
def built_opq():
    return _jax_index(31, opq=True)


def carry(j, device="cpu"):
    st = j.store
    return IVFADCGroupingIndex.from_numpy_state(
        IndexConfig(do_opq=j.do_opq, **CFG), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets,
        np.asarray(j.nn_centroid_idxs), np.asarray(j.alphas),
        np.asarray(j.inter_centroid_dists),
        np.asarray(j.opq_R) if j.do_opq else None, device)


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


PORT_ENGINES = [("torch", "auto"), ("fused", "chunk"), ("fused", "quad")]


def _search_vs_xla(j, queries, p, port):
    j.engine = "xla"
    try:
        d1, l1 = j.search(queries, JaxParams(**p))
    finally:
        j.engine = "auto"
    t = carry(j)
    t.engine, t.scan_layout = port
    d2, l2 = t.search(queries, SearchParams(**p))
    assert d2.shape == (len(queries), 10) and l2.dtype == np.int64
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)


@pytest.mark.parametrize("p", list(PARAMS), ids=list(PARAMS))
@pytest.mark.parametrize("port", PORT_ENGINES, ids=lambda x: "-".join(x))
def test_search_matches_jax_xla(built, p, port):
    j, _, queries = built
    _search_vs_xla(j, queries, PARAMS[p], port)


@pytest.mark.parametrize("port", PORT_ENGINES, ids=lambda x: "-".join(x))
def test_search_opq_matches_jax_xla(built_opq, port):
    """OPQ carried across: LUTs from the rotated queries, coarse selection
    and the grouping terms in the original space."""
    j, _, queries = built_opq
    _search_vs_xla(j, queries, PARAMS["prune"], port)


def test_search_batches_and_auto_engine(built):
    """Several query batches and engine "auto" (= fused) give the one-batch
    torch-engine result."""
    j, _, queries = built
    t = carry(j)
    assert t._resolve_engine() == "fused"
    p = SearchParams(**PARAMS["prune"])
    d2, l2 = t.search(queries, p, batch=7)
    t.engine = "torch"
    d1, l1 = t.search(queries, p)
    assert_same(d1, l1, d2, l2)


def _near_tie_slack(x, keys, C, nn, nnd, nc):
    """Per group, how far its (num, den) sums may move when points whose
    best candidate directions are a near-tie (distances within 1e-5
    relative, in float64) pick the other one: the spread of num and den
    over each such point's near-tied candidates, summed per group."""
    c = C[keys].astype(np.float64)
    cv = C[nn[keys]] - c[:, None]
    num = np.maximum(np.einsum("bsd,bd->bs", cv, x - c), 0.0)
    den = nnd[keys].astype(np.float64)
    s = c[:, None] + (num / np.maximum(den, 1e-30))[:, :, None] * cv
    dist = ((x[:, None] - s) ** 2).sum(-1)
    tied = dist <= dist.min(1, keepdims=True) * (1 + 1e-5) + 1e-9
    slack = np.zeros((nc, 2))
    for v, col in ((num, 0), (den, 1)):
        spread = (np.where(tied, v, -np.inf).max(1)
                  - np.where(tied, v, np.inf).min(1))
        np.add.at(slack[:, col], keys, spread)
    return slack


def test_alpha_stats_match_jax(built):
    """Sums within rtol 1e-5, beyond that only by what points at a
    demonstrated near-tie between two candidate directions can move."""
    j, base, _ = built
    x = base[:3000]
    keys = j.assign(x)
    args = (np.array(j.centroids), np.array(j.nn_centroid_idxs),
            np.array(j.inter_centroid_dists))
    jn, jd = jg._alpha_stats(jnp.asarray(x), jnp.asarray(keys),
                             *map(jnp.asarray, args))
    tn, td = tg._alpha_stats(torch.from_numpy(x),
                             torch.from_numpy(keys.astype(np.int64)),
                             *map(torch.from_numpy, args))
    slack = _near_tie_slack(x, keys, *args, CFG["nc"])
    for t, r, col in ((tn, jn, 0), (td, jd, 1)):
        t, r = t.numpy(), np.asarray(r)
        assert (np.abs(t - r) <= 1e-5 * np.abs(r) + 1e-5
                + slack[:, col] * (1 + 1e-5)).all(), (t, r, slack[:, col])
    assert np.isclose(tn.numpy(), np.asarray(jn), rtol=1e-5).mean() > 0.9


def test_alpha_pass_and_finalize_match_jax(built):
    """The port's two-batch alpha pass from JAX's centroids and neighbours
    reproduces JAX's alphas."""
    j, base, _ = built
    t = carry(j)
    keys = j.assign(base)
    t.alpha_pass(base[:5000], keys[:5000], batch=2048)
    t.alpha_pass(base[5000:], keys[5000:])
    t.finalize_alphas()
    ta, ja = t.alphas.numpy(), np.asarray(j.alphas)
    # Beyond rtol 1e-5 only where near-ties move num and den (see above).
    num, den = t._alpha_num, t._alpha_den
    sn, sd = _near_tie_slack(base, keys, np.asarray(j.centroids),
                             np.asarray(j.nn_centroid_idxs),
                             np.asarray(j.inter_centroid_dists),
                             CFG["nc"]).T
    bound = (sn + ja * sd) / np.maximum(den - sd, 1e-30)
    assert (np.abs(ta - ja) <= 1e-5 * np.abs(ja) + 1e-7 + bound).all()
    assert np.isclose(ta, ja, rtol=1e-5).mean() > 0.9
    assert np.isfinite(num).all() and (den > 0).all()


def test_subcentroid_assign_matches_jax(built):
    j, base, _ = built
    keys = j.assign(base)
    args = (np.array(j.centroids), np.array(j.nn_centroid_idxs),
            np.array(j.alphas))
    ji, js = jg._subcentroid_assign(jnp.asarray(base), jnp.asarray(keys),
                                    *map(jnp.asarray, args))
    ti, ts = tg._subcentroid_assign(torch.from_numpy(base),
                                    torch.from_numpy(keys.astype(np.int64)),
                                    *map(torch.from_numpy, args))
    ji, ti = np.asarray(ji), ti.numpy()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    for r in np.nonzero(ji != ti)[0]:       # only near-ties may differ
        c = args[0][keys[r]]
        s = c + args[2][keys[r]] * (args[0][args[1][keys[r]]] - c)
        dist = ((base[r] - s) ** 2).sum(-1)
        assert abs(dist[ji[r]] - dist[ti[r]]) <= 1e-5 * dist[ji[r]], r


def test_neighbor_centroids_match_jax(built):
    j, _, _ = built
    t = IVFADCGroupingIndex(IndexConfig(**CFG), "cpu")
    t.set_centroids(np.asarray(j.centroids))
    t.compute_neighbor_centroids()
    np.testing.assert_array_equal(t.nn_centroid_idxs.numpy(),
                                  np.asarray(j.nn_centroid_idxs))
    np.testing.assert_allclose(t.inter_centroid_dists.numpy(),
                               np.asarray(j.inter_centroid_dists),
                               rtol=1e-5, atol=1e-4)
    t.compute_inter_centroid_dists()
    j2 = JaxGrouping(JaxConfig(**CFG))
    j2.set_centroids(np.asarray(j.centroids))
    j2.nn_centroid_idxs = j.nn_centroid_idxs
    j2.compute_inter_centroid_dists()
    np.testing.assert_allclose(t.inter_centroid_dists.numpy(),
                               np.asarray(j2.inter_centroid_dists),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["self_present", "self_absent"])
def test_drop_self_keeps_the_jax_rule(case):
    """The vectorised rule against the JAX package's per-row loop
    (grouping.py:289-294): without the row's own id among the nsubc+1
    columns, the last (farthest) column goes."""
    rng = np.random.RandomState(5)
    S, n = 4, 6
    idxs = np.stack([rng.permutation(50)[:S + 1] + 10 for _ in range(n)])
    rows = np.arange(n)[:, None]
    if case == "self_present":
        idxs[np.arange(n), rng.randint(0, S + 1, n)] = rows[:, 0]
    dists = np.sort(rng.rand(n, S + 1).astype(np.float32), axis=1)
    td, ti = tg._drop_self(torch.from_numpy(dists), torch.from_numpy(idxs),
                           torch.from_numpy(rows), S)
    for r in range(n):                      # the JAX loop, verbatim
        keep = np.nonzero(idxs[r] != rows[r, 0])[0][:S]
        np.testing.assert_array_equal(ti[r].numpy(), idxs[r, keep])
        np.testing.assert_array_equal(td[r].numpy(), dists[r, keep])


def test_own_add_bit_equal_store(built):
    """The port's add_batch, given JAX's quantizers, neighbours and alphas,
    reproduces JAX's subgroup store bit for bit."""
    j, base, _ = built
    t = carry(j)
    t.builder = type(t.builder)(CFG["nc"] * CFG["nsubc"], 8)
    half = len(base) // 2
    t.add_batch(base[:half], np.arange(half, dtype=np.int32), batch=1000)
    t.add_batch(base[half:])                # ids continue from ntotal
    t.finalize()
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(getattr(t.store, name),
                                      getattr(j.store, name), err_msg=name)


def test_grouped_view_of_the_store(built):
    j, _, _ = built
    t = carry(j)
    gv = t.store.grouped(CFG["nsubc"])
    off = np.asarray(j.store.list_offsets).astype(np.int64)
    np.testing.assert_array_equal(gv.group_offsets_t.numpy(), off[::8])
    np.testing.assert_array_equal(gv.sub_sizes_t.numpy(),
                                  np.diff(off).reshape(32, 8))
    lists = np.repeat(np.arange(32 * 8), np.diff(off))
    np.testing.assert_array_equal(gv.subc_t.numpy(), lists % 8)
    # The JAX chunk tiles carry the same subcentroid bytes in row 17.
    tiled = j.store.tiled_grouped(8)
    g = int(np.argmax(gv.group_sizes > 0))
    n0 = int(gv.group_sizes[g])
    t0 = int(np.asarray(tiled.tile_offsets)[g])
    row17 = np.asarray(tiled.tiles)[t0:, 17, :].reshape(-1)[:n0]
    np.testing.assert_array_equal(row17, gv.subc_t.numpy()[off[8 * g]:][:n0])


@pytest.mark.parametrize("gran", [256, 1024])
def test_schedule_skips_fully_pruned_groups(gran):
    """The port's counterpart of test_grouping_pallas.py::
    test_schedule_skips_fully_pruned_groups: a group whose subgroups are
    all pruned gets no slot; the others take whole-group slots."""
    probes = torch.tensor([[0, 1, 2]])
    term1 = torch.tensor([[0.5, 1.5, 2.5]])
    eff = torch.tensor([[100, 0, 50]])              # probe 1 fully pruned
    full = torch.tensor([[100, 300, 300]])          # group windows
    goff = torch.tensor([0, 100, 400, 700])
    start, ln, bias, seg = tgs.grouping_schedule(probes, term1, eff, full,
                                                 goff, 0, 6, gran)
    active = ln[0] > 0
    assert int(active.sum()) == (2 if gran == 1024 else 3)
    assert not (seg[0][active] == 1).any()
    assert int(ln[0].sum()) == 100 + 300            # whole groups 0 and 2
    assert start[0, 0] == 0 and start[0, 1] == 400
    assert bias[0, 0] == 0.5 and bias[0, 1] == 2.5
    # A binding budget: probe 0's 100 unpruned codes reach max_codes=100.
    _, ln2, _, seg2 = tgs.grouping_schedule(probes, term1, eff, full, goff,
                                            100, 6, gran)
    assert int(ln2[0].sum()) == 100 and not (seg2[0][ln2[0] > 0] != 0).any()


def test_search_guards(built):
    j, _, queries = built
    t = carry(j)
    with pytest.raises(NotImplementedError):
        t.enable_routed_coarse()
    with pytest.raises(NotImplementedError):
        t.search(queries, SearchParams(k=5, coarse_mode="routed"))
    with pytest.raises(NotImplementedError):   # IVFADC's, not the grouping's
        t.scan_inputs(torch.from_numpy(queries), SearchParams(k=5))
    with pytest.raises(RuntimeError):
        IVFADCGroupingIndex(IndexConfig(**CFG), "cpu").search(queries)
    with pytest.raises(ValueError):
        IVFADCGroupingIndex(IndexConfig(**dict(CFG, nsubc=300)), "cpu")


def test_driver_cpu_runs_and_prints_recall():
    out = subprocess.run(
        [sys.executable, "-m", "ivfhnsw_tpu_torch.drivers.grouping_eval",
         "-synthetic", "0", "-device", "cpu", "-d", "32", "-nc", "32",
         "-code_size", "8", "-nsubc", "8", "-nb", "5000", "-nt", "2000",
         "-nq", "100", "-nprobe", "8", "-max_codes", "1000", "-k", "10",
         "-do_pruning", "on", "-do_opq", "on"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    r1 = [ln for ln in out.stdout.splitlines() if ln.startswith("Recall@1:")]
    assert r1 and 0.0 < float(r1[0].split()[1]) <= 1.0, out.stdout
    assert "alpha pass" in out.stdout and "Time per query" in out.stdout


def test_driver_refuses_unported_flags(tmp_path):
    """The -path_* flags are served, not refused: the OPQ rotation is
    written beside the quantizers and loaded by the next run (the files
    against the JAX package's: tests/test_torch_files.py). What the driver
    refuses is a flag it does not know."""
    argv = ["-synthetic", "0", "-device", "cpu", "-d", "32", "-nc", "32",
            "-code_size", "8", "-nsubc", "8", "-nb", "3000", "-nt", "2000",
            "-nq", "50", "-nprobe", "8", "-max_codes", "1000", "-k", "10",
            "-do_opq", "on", "-path_pq", str(tmp_path / "x.pq"),
            "-path_norm_pq", str(tmp_path / "x.norm_pq"),
            "-path_opq_matrix", str(tmp_path / "x.opq")]
    r1 = grouping_eval.main(argv)
    assert sorted(os.listdir(tmp_path)) == ["x.norm_pq", "x.opq", "x.pq"]
    r2 = grouping_eval.main(argv)
    assert r2["stages"]["how"]["pq"] == "loaded"
    np.testing.assert_array_equal(r2["labels"], r1["labels"])
    with pytest.raises(ValueError, match="unknown flag"):
        grouping_eval.main(argv + ["-path_graph", "x.bin"])
