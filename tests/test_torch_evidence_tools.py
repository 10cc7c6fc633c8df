"""The port's evidence tools (ivfhnsw_tpu_torch/tools/assign_ab.py,
coarse_ab.py, routed_tune.py, siftlike_scale_calibrate.py,
siftlike_calibrate.py) and the scale3sl record fields they feed, against
the JAX rigs of tools/ on the CPU:

- their constants and default arguments, read from the JAX rigs' text
  (routed_tune's six structures and ws, assign_ab's defaults and n_super
  rule, siftlike_scale_calibrate's CODE_SIZE = 128, i.e. pq_m 128);
- siftlike_calibrate's base and query arrays bit for bit;
- assign_ab's core on one numpy stream fed to both packages (the same
  centroids and quantizers, carried across with from_numpy_state): the
  exact twin's keys, store and R@k against JAX's, and each routed twin's
  drift series against a count made here;
- coarse_ab's overlap against the JAX rig's own expression, and its binned
  probes against JAX's;
- routed_tune's overlap per (structure, w) on JAX's routing state;
- eval_scale3sl's evidence fields with and without the artifacts (the
  committed TPU records never opened);
- the routed gate's top-100 result overlap moving with w at the bench
  tool's smoke sizes (ROADMAP Q2), and its missing labels' classes;
- marginal_ms's arithmetic; every tool's default device, cuda.

Tolerances: tests/test_pallas_adc.py:42-46 (rtol 1e-4, atol 1e-3; labels
may differ only at ties); keys may differ only at shown near-ties (D3).
"""

import ast
import builtins
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.ops import routed_coarse as jrc
from ivfhnsw_tpu.ops.distances import streaming_topk_l2 as jax_topk
from ivfhnsw_tpu.utils.siftlike import SiftLikeCorpus as JaxCorpus
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.ops.routed_coarse import RoutedCoarse
from ivfhnsw_tpu_torch.tools import assign_ab, coarse_ab
from ivfhnsw_tpu_torch.tools import bench as tb
from ivfhnsw_tpu_torch.tools import routed_tune
from ivfhnsw_tpu_torch.tools import siftlike_calibrate as scal
from ivfhnsw_tpu_torch.tools import siftlike_scale_calibrate as sscal
from ivfhnsw_tpu_torch.utils import profiling
from ivfhnsw_tpu_torch.utils.recall import recall_at_k

torch.set_num_threads(4)
RTOL, ATOL = 1e-4, 1e-3
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rig(name: str) -> str:
    with open(os.path.join(ROOT, "tools", name + ".py")) as f:
        return f.read()


def _consts(src: str) -> dict:
    """Module-level NAME = constant-expression assignments of a rig."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign):
            try:   # literals and arithmetic on them (8 * 1024 * 1024)
                val = eval(compile(ast.Expression(node.value), "<rig>",
                                   "eval"), {"__builtins__": {}})
            except (NameError, TypeError):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = val
                elif isinstance(t, ast.Tuple):
                    out.update({e.id: v for e, v in zip(t.elts, val)})
    return out


def _defaults(src: str) -> dict:
    """``add_argument(flag, ..., default=...)`` defaults of a rig."""
    out = {}
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[node.args[0].value] = ast.literal_eval(kw["default"])
    return out


def _ints(pattern: str, src: str) -> list:
    return [int(x.replace("_", "")) for x in re.findall(pattern, src)]


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

def _check_assign_ab(src):
    assert _defaults(src) == {"--nb": 16_777_216, "--nprobe": 128,
                              "--max-codes": 100_000}
    assert "n_sup = min(2048, nc // 4)" in src
    assert all(assign_ab.n_super_for(nc) == min(2048, nc // 4)
               for nc in (128, 4096, 131_072, 1 << 20))
    assert set(_ints(r"PRNGKey\((\d[\d_]*)\)", src)) == {
        assign_ab.SEEDS[k] for k in ("queries", "learn", "router")} | {0}
    assert "seed=13" in src and assign_ab.SEEDS["corpus"] == 13
    assert _ints(r"PRNGKey\((\d[\d_]*) \+ bi\)", src) == [
        assign_ab.SEEDS["base"]]
    assert _ints(r"bs = (\d[\d_]*)", src) == [assign_ab.BATCH]
    assert _ints(r"min\((\d[\d_]*), NB\)", src) == [assign_ab.PQ_ROWS]
    assert _ints(r"batch=(\d+)", src) == [assign_ab.SEARCH_BATCH]
    assert [v for v in ("exact", "routed_w4", "routed_w16") if f'"{v}"' in
            src] == list(assign_ab.VARIANTS)
    assert assign_ab.ROUTED_W == {"routed_w4": 4, "routed_w16": 16}
    port = _defaults(open(assign_ab.__file__).read())
    assert {k: port[k] for k in _defaults(src)} == _defaults(src)


def _check_coarse_ab(src):
    port = _defaults(open(coarse_ab.__file__).read())
    assert _defaults(src) == {"--nprobe": 128, "--max-codes": 100_000,
                              "--runs": 2}
    assert {k: port[k] for k in _defaults(src)} == _defaults(src)
    assert 'for mode in ("auto", "binned")' in src
    assert coarse_ab.MODES == ("auto", "binned")
    assert "min(64, q.shape[0])" in src and coarse_ab.N_CTL == 64
    assert "recall_target=0.95" in src and "depth=8" in src
    assert tb.DEPTH == 8


def _check_routed_tune(src):
    m = re.search(r"configs = (\[.*?\])", src, re.S)
    assert tuple(ast.literal_eval(m.group(1))) == routed_tune.CONFIGS
    assert "configs[:4]" in src and routed_tune.QUICK == 4
    assert tuple(ast.literal_eval(re.search(r"ws = (\(.*?\))", src)
                                  .group(1))) == routed_tune.WS
    assert _defaults(src) == {"--stage": "scale2", "-B": 256}
    port = _defaults(open(routed_tune.__file__).read())
    assert port["--stage"] == "scale2" and port["-B"] == 256
    assert _ints(r"PRNGKey\((\d+)\)", src) == [0, routed_tune.SEED]
    assert "if w > rc.n_super or w * rc.cap < NPROBE:" in src


def _check_scale_calibrate(src):
    c = _consts(src)
    assert {k: c[k] for k in ("NB", "NC", "NQ", "D", "CODE_SIZE")} == {
        "NB": sscal.NB, "NC": sscal.NC, "NQ": sscal.NQ, "D": sscal.D,
        "CODE_SIZE": sscal.CODE_SIZE}
    # the quirk: CODE_SIZE counts bytes, so the rig runs pq_m 128 of one
    # dimension each, in both packages
    assert sscal.CODE_SIZE == 128
    assert JaxConfig(d=128, nc=1, code_size=c["CODE_SIZE"]).pq_m == 128
    assert IndexConfig(d=128, nc=1, code_size=sscal.CODE_SIZE).pq_m == 128
    assert IndexConfig(d=128, nc=1, code_size=sscal.CODE_SIZE).dsub == 1
    assert '["0.75:1048576:3"]' in src
    assert sscal.parse_spec(sscal.DEFAULT_SPEC) == (0.75, 1_048_576, 3.0)
    assert _ints(r"batch_device\(jr\.PRNGKey\(1\), (\d[\d_]*)\)", src) == [
        sscal.LEARN]
    assert _ints(r"learn\[:(\d[\d_]*)\]", src) == [sscal.PQ_ROWS]
    assert "niter=4" in src and "PRNGKey(999_999)" in src
    assert _ints(r"PRNGKey\((\d[\d_]*) \+ bi\)", src) == [10_000]
    assert _ints(r"bs = (\d[\d_]*)", src) == [sscal.BATCH]


def _check_calibrate(src):
    c = _consts(src)
    assert (c["NB"], c["NQ"], c["NC"]) == (scal.NB, scal.NQ, scal.NC)
    assert "n_classes=16384, sigma=sigma, seed=1" in src
    assert (scal.N_CLASSES, scal.CORPUS_SEED) == (16384, 1)
    assert _ints(r"corpus\.batch\((\d[\d_]*), seed=100 \+ i\)", src) == [
        scal.BASE_BATCH]
    assert "seed=999)" in src and scal.QUERY_SEED == 999
    assert "[0.35, 0.55, 0.75]" in src and scal.SIGMAS == (0.35, 0.55, 0.75)
    assert "base[:300_000], niter=8" in src and "base[:65_536]" in src
    assert "code_size=16" in src


@pytest.mark.parametrize("rig,check", [
    ("assign_ab", _check_assign_ab), ("coarse_ab", _check_coarse_ab),
    ("routed_tune", _check_routed_tune),
    ("siftlike_scale_calibrate", _check_scale_calibrate),
    ("siftlike_calibrate", _check_calibrate)])
def test_constants_are_the_jax_rigs(rig, check):
    check(_rig(rig))


# ---------------------------------------------------------------------------
# siftlike_calibrate's corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", scal.SIGMAS)
def test_siftlike_calibrate_draws_are_jax_bit_for_bit(sigma):
    base, queries = scal.corpus(sigma)
    c = JaxCorpus(n_classes=16384, sigma=sigma, seed=1)
    assert base.shape == (scal.NB, 128) and queries.shape == (scal.NQ, 128)
    for i in range(scal.NB // 64_000):
        assert np.array_equal(base[i * 64_000:(i + 1) * 64_000],
                              c.batch(64_000, seed=100 + i)), i
    assert np.array_equal(queries, c.batch(1024, seed=999))


# ---------------------------------------------------------------------------
# assign_ab's core on one stream
# ---------------------------------------------------------------------------

D_AB, NC_AB, NQ_AB, BS_AB, NBATCH = 32, 64, 48, 3000, 3


def _ab_stream():
    rng = np.random.RandomState(21)
    groups = rng.randn(16, D_AB).astype(np.float32) * 4
    cents = (groups[rng.randint(0, 16, NC_AB)]
             + rng.randn(NC_AB, D_AB).astype(np.float32))

    def draw(n):
        return (cents[rng.randint(0, NC_AB, n)]
                + rng.randn(n, D_AB).astype(np.float32) * 1.5)

    return cents, draw(2000), [draw(BS_AB) for _ in range(NBATCH)], draw(
        NQ_AB)


@pytest.fixture(scope="module")
def ab_pair():
    """One stream through the port's A/B and through JAX's rig loop (its
    ``_assign_device_exact``, ``_encode_batch``, builder), the same
    centroids and JAX's quantizers carried across."""
    cents, learn, batches, queries = _ab_stream()
    cfg = dict(d=D_AB, nc=NC_AB, code_size=8)
    j = JaxIndex(JaxConfig(**cfg))
    j.set_centroids(cents)
    j.train_pq(jax.random.PRNGKey(0), learn, pq_niter=5)
    M = j.config.pq_m
    proto = IVFADCIndex.from_numpy_state(
        IndexConfig(**cfg), cents, np.asarray(j.pq.codebooks),
        np.asarray(j.norm_pq.centroids), np.zeros((0, M), np.uint8),
        np.zeros(0, np.int32), np.zeros(0, np.uint8),
        np.zeros(NC_AB + 1, np.int64), "cpu")
    ab = assign_ab.ABStream(assign_ab.twins(proto),
                            assign_ab.routers(proto.centroids),
                            torch.from_numpy(queries))
    keys_port, keys_jax = [], []
    for bi, blk in enumerate(batches):
        off = bi * BS_AB
        keys_port.append(ab.add(bi, off, torch.from_numpy(blk)))
        kj = j._assign_device_exact(jnp.asarray(blk))
        codes, ncodes = j._encode_batch(jnp.asarray(blk), jnp.asarray(kj))
        j.builder.add(kj, np.arange(off, off + BS_AB, dtype=np.int32),
                      np.asarray(codes), np.asarray(ncodes))
        keys_jax.append(np.asarray(kj))
    j.finalize()
    rec = assign_ab.evaluate(ab, queries, NBATCH * BS_AB, nprobe=16,
                             max_codes=2000)
    return dict(j=j, ab=ab, rec=rec, batches=batches, queries=queries,
                cents=cents, keys_port=keys_port, keys_jax=keys_jax)


def test_assign_ab_exact_twin_equals_jax(ab_pair):
    p = ab_pair
    cents = p["cents"].astype(np.float64)
    for blk, kp, kj in zip(p["batches"], p["keys_port"], p["keys_jax"]):
        mism = np.nonzero(kp["exact"] != kj)[0]
        assert mism.size <= 2, mism.size
        for i in mism:                       # D3: a near-tie
            x = blk[i].astype(np.float64)
            dp, dj = (((x - cents[k]) ** 2).sum() for k in
                      (kp["exact"][i], kj[i]))
            assert abs(dp - dj) <= 1e-5 * (x * x).sum() + 1e-4
    st_p, st_j = p["ab"].idxs["exact"].store, p["j"].store
    if all(np.array_equal(kp["exact"], kj) for kp, kj in
           zip(p["keys_port"], p["keys_jax"])):
        for f in ("codes", "norm_codes", "ids", "list_offsets"):
            assert np.array_equal(np.asarray(getattr(st_p, f)),
                                  np.asarray(getattr(st_j, f))), f
    # the in-stream ground truth: the float64 brute force's top-1 but at
    # ties
    base = np.concatenate(p["batches"]).astype(np.float64)
    q = p["queries"].astype(np.float64)
    d2 = ((q[:, None, :] - base[None]) ** 2).sum(-1)
    gt = p["ab"].gt.labels.numpy()
    np.testing.assert_allclose(d2[np.arange(len(q)), gt[:, 0]], d2.min(1),
                               rtol=RTOL, atol=ATOL)
    # R@k of the exact twin: the tool's record against JAX's search of its
    # own twin, under the same profiled budget, against the same gt
    sp = JaxParams(k=100, nprobe=16, max_codes=2000)
    dem = int(np.asarray(p["j"].scan_slot_demand(p["queries"], sp)).max())
    sp = JaxParams(k=100, nprobe=16, max_codes=2000,
                   scan_budget=dem * p["j"].scan_unit())
    _, lj = p["j"].search(p["queries"], sp, batch=256)
    rj = recall_at_k(np.asarray(lj), gt, ks=(1, 10, 100))
    e = p["rec"]["variants"]["exact"]
    assert [e[f"recall_at_{k}"] for k in (1, 10, 100)] == [
        rj[k] for k in (1, 10, 100)]
    sizes = np.diff(np.asarray(st_j.list_offsets))
    assert (e["list_size_max"], e["empty_lists"]) == (
        int(sizes.max()), int((sizes == 0).sum()))


def test_assign_ab_drift_series_is_the_routed_match_count(ab_pair):
    p = ab_pair
    cents = p["cents"].astype(np.float64)
    csq = (cents * cents).sum(1)
    for v, r in p["ab"].routers.items():
        series = []
        for bi, blk in enumerate(p["batches"]):
            x = blk.astype(np.float64)
            exact = np.argmin(csq[None] - 2 * x @ cents.T, 1)
            routed = r.assign(blk)
            series.append({"batch": bi,
                           "match_rate": float((routed == exact).mean())})
        e = p["rec"]["variants"][v]
        assert e["drift_series"] == series, v
        rates = [s["match_rate"] for s in series]
        assert e["mean_match_rate"] == pytest.approx(np.mean(rates))
        assert e["drift_min_match_rate"] == min(rates)
        # the twin holds every row under the routed keys
        assert p["ab"].idxs[v].store.ntotal == NBATCH * BS_AB
    assert p["ab"].routers["routed_w16"].w == 16
    assert p["ab"].routers["routed_w4"].n_super == NC_AB // 4
    assert "drift_series" not in json.dumps(assign_ab.summary(p["rec"]))


# ---------------------------------------------------------------------------
# coarse_ab's overlap and probes
# ---------------------------------------------------------------------------

def test_coarse_ab_overlap_is_the_jax_rigs_expression():
    """The JAX rig's own expression (tools/coarse_ab.py, evaluated from
    its text) and the port's function on the same probe arrays, with
    repeated probes that count once."""
    m = re.search(r"ovl = (float\(np\.mean\(\[.*?\)\]\)\))",
                  _rig("coarse_ab"), re.S)
    rng = np.random.RandomState(4)
    exact = np.stack([rng.permutation(200)[:24] for _ in range(32)])
    pr = np.where(rng.rand(32, 24) < 0.7, exact,
                  rng.randint(0, 200, (32, 24)))
    pr[:4, :3] = pr[:4, :1]               # duplicates count once
    want = eval(m.group(1), {"np": np, "pr": pr, "probes_exact": exact})
    assert coarse_ab.probe_overlap(pr, exact) == want
    assert routed_tune.overlap(pr, exact) == want


def test_coarse_ab_binned_probes_equal_jax():
    rng = np.random.RandomState(8)
    cents = rng.randn(4096, 32).astype(np.float32)
    q = rng.randn(64, 32).astype(np.float32)
    idx = IVFADCIndex(IndexConfig(d=32, nc=4096, code_size=8), CPU)
    idx.set_centroids(cents)
    got = coarse_ab.mode_probes(idx, torch.from_numpy(q), 32,
                                "binned").numpy()
    jd, jp = jax_topk(jnp.asarray(q), jnp.asarray(cents), 32,
                      block=idx._coarse_block_for(64),
                      point_sqnorms=jnp.sum(jnp.asarray(cents) ** 2, 1),
                      exact_reduce="binned",
                      precision=jax.lax.Precision.HIGHEST)
    jp = np.asarray(jp)
    for i in range(64):
        diff = set(got[i].tolist()) ^ set(jp[i].tolist())
        assert not diff or np.isclose(
            np.asarray(jd)[i, -1], ((q[i] - cents[list(diff)]) ** 2).sum(1),
            rtol=RTOL, atol=ATOL).all(), i
    # the port's approx keeps its promise (D1: a bucketed reduction)
    ap = coarse_ab.mode_probes(idx, torch.from_numpy(q), 32, "auto").numpy()
    assert coarse_ab.probe_overlap(ap, jp) >= 0.95


# ---------------------------------------------------------------------------
# routed_tune's overlap on JAX's routing state
# ---------------------------------------------------------------------------

NC_RT = 2048     # nc 2^17 / 64: each structure's n_super scaled alike


@pytest.mark.parametrize("n_super,capf", routed_tune.CONFIGS)
def test_routed_tune_overlap_equals_jax(n_super, capf):
    rng = np.random.RandomState(11)
    groups = rng.randn(48, 32).astype(np.float32) * 5
    cents = (groups[rng.randint(0, 48, NC_RT)]
             + rng.randn(NC_RT, 32).astype(np.float32))
    q = (cents[rng.randint(0, NC_RT, 96)]
         + rng.randn(96, 32).astype(np.float32) * 0.7)
    nprobe = 24
    ns = n_super * NC_RT // 131_072
    jr = jrc.RoutedCoarse(cents, n_super=ns, cap_factor=capf,
                          key=jax.random.PRNGKey(routed_tune.SEED))
    sizes = rng.randint(0, 500, NC_RT).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cn = (cents * cents).sum(1)
    jtab = jr.build_table(cn, sizes, offs[:-1].astype(np.int32))
    rc = RoutedCoarse.from_state(torch.from_numpy(cents),
                                 np.asarray(jr.supers), jr.members, jr.valid)
    idx = IVFADCIndex(IndexConfig(d=32, nc=NC_RT, code_size=8), CPU)
    idx.set_centroids(cents)
    ex = routed_tune.exact_probes(idx, torch.from_numpy(q), nprobe).numpy()
    rows = routed_tune.sweep_structure(
        rc, rc.build_table(torch.from_numpy(cn), torch.from_numpy(offs)),
        torch.from_numpy(q), ex, nprobe, timed=False)
    want = [w for w in routed_tune.WS
            if not (w > jr.n_super or w * jr.cap < nprobe)]
    assert [r["w"] for r in rows] == want and want
    for r in rows:
        _, jp, *_ = jrc.routed_select_ext(jnp.asarray(q), jr.supers,
                                          jr.super_sqn, jtab,
                                          nprobe=nprobe, w=r["w"])
        jov = float(np.mean([np.intersect1d(ex[i], np.asarray(jp)[i]).size
                             / nprobe for i in range(len(q))]))
        assert r["overlap"] == jov, (r["w"], r["overlap"], jov)
        assert r["candidates"] == r["w"] * jr.cap


# ---------------------------------------------------------------------------
# The scale3sl record's evidence fields
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s3sl(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("s3sl"))
    S = tb.sizes(True)
    return (cache, S, *tb.build_scale3sl(S, CPU, cache))


AB_FILE = {"nb": 4096, "nc": 128, "nprobe": 128, "max_codes": 100_000,
           "corpus": assign_ab.CORPUS, "variants": {
               "exact": {"recall_at_1": 0.5, "assign_seconds": 1.0},
               "routed_w4": {"recall_at_1": 0.4, "mean_match_rate": 0.8,
                             "drift_min_match_rate": 0.75,
                             "drift_series": [{"batch": 0,
                                               "match_rate": 0.75}]}}}
CAB_FILE = {"nb": 4096, "nc": 512, "modes": {"auto": {"qps": 1.0}},
            "binned_minus_auto_us": 0.5}


@pytest.mark.parametrize("present", [False, True])
def test_eval_scale3sl_evidence_fields(s3sl, present, monkeypatch):
    cache, S, idx, q, gt, meta = s3sl
    if present:
        tb._dump(os.path.join(cache, "assign_ab.json"), AB_FILE)
        tb._dump(os.path.join(cache, "coarse_ab.json"), CAB_FILE)
    else:
        for f in ("assign_ab.json", "coarse_ab.json"):
            if os.path.exists(os.path.join(cache, f)):
                os.remove(os.path.join(cache, f))
    real_open, opened = builtins.open, []

    def spy(path, *a, **k):
        opened.append(str(path))
        if "RESULTS_" in os.path.basename(str(path)):
            raise AssertionError(f"opened the committed record {path}")
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    rec = tb.eval_scale3sl(idx, q, gt, meta, S, cache, True)
    monkeypatch.setattr(builtins, "open", real_open)
    assert meta["assignment_mode"].startswith("exact")  # the gate fired
    assert rec["scale3sl_drift_min_match_rate"] is None or present
    new = {"scale3sl_coarse_ab", "scale3sl_assign_ab",
           "scale3sl_drift_source"}
    if not present:
        assert not new & set(rec)
        return
    assert rec["scale3sl_coarse_ab"] == CAB_FILE
    ab = rec["scale3sl_assign_ab"]
    assert (ab["nb"], ab["nc"], ab["source"]) == (4096, 128, "cache")
    assert "drift_series" not in json.dumps(ab)
    assert ab["variants"]["routed_w4"]["drift_min_match_rate"] == 0.75
    assert rec["scale3sl_drift_min_match_rate"] == 0.75
    assert rec["scale3sl_drift_source"] == tb.DRIFT_SOURCE
    assert not any("RESULTS_" in p for p in opened)


def test_evidence_fields_keep_the_builds_own_drift(tmp_path):
    tb._dump(os.path.join(tmp_path, "assign_ab.json"), AB_FILE)
    ev = tb.evidence_fields(str(tmp_path), 0.99)
    assert set(ev) == {"scale3sl_assign_ab"}
    assert tb.evidence_fields(str(tmp_path / "none"), None) == {}


# ---------------------------------------------------------------------------
# ROADMAP Q2: the routed gate's result overlap moves with w
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s2(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("s2"))
    S = tb.sizes(True)
    idx, q, gt, meta = tb.build_scale2(S, CPU, cache)
    idx.enable_routed_coarse(generator=torch.Generator().manual_seed(
        routed_tune.SEED))
    return S, idx, q


def test_routed_result_overlap_moves_with_w(s2):
    """bench.routed_setup's top-100 result overlap (result_search /
    result_overlap) at the smoke sizes: it rises with w, and at w =
    n_super, where the probe sets are the exact ones, it is 1 but for
    queries whose probes hold fewer than 100 codes."""
    S, idx, q = s2
    P, mc = S["S2_NPROBE"], S["S2_MC"]
    _, l_ex = tb.result_search(idx, q, P, mc, "exact")
    got = {}
    for w in (1, 2, 4, 8, idx._routed_coarse.n_super):
        idx.routed_w = w
        _, l_rt = tb.result_search(idx, q, P, mc, "routed")
        got[w] = tb.result_overlap(l_ex, l_rt)
    vals = list(got.values())
    assert all(a < b for a, b in zip(vals, vals[1:])), got
    full = float(np.mean((l_ex >= 0).sum(1) / tb.RESULT_K))
    assert vals[-1] == pytest.approx(full, abs=1e-3), got
    assert vals[0] < 0.9 * full


def test_result_overlaps_classify_every_missing_label(s2):
    S, idx, q = s2
    recs = routed_tune.result_overlaps(idx, q, S["S2_NPROBE"], S["S2_MC"],
                                       ws=(1, 4), out=lambda m: None)
    assert [r["w"] for r in recs] == [1, 4, idx._routed_coarse.n_super]
    for r in recs:
        assert r["missing"] == (r["outranked"] + r["not_probed"]
                                + r["admitted"])
        assert r["not_probed_fallback"] <= r["not_probed"]
        assert r["queries_missing"] <= len(q)
    assert recs[0]["missing"] > recs[1]["missing"] > recs[2]["missing"]
    assert recs[0]["not_probed"] > 0 and recs[2]["probe_overlap"] == 1.0


def test_placement_marks_the_partitions_fallback():
    """Each centroid's holding super, and whether it lies outside the
    centroid's 8 nearest supers (the partition's fallback when those are
    full), against a numpy count; a tight cap forces fallbacks."""
    rng = np.random.RandomState(13)
    cents = np.concatenate([rng.randn(200, 16) * 0.3,
                            rng.randn(56, 16) * 6]).astype(np.float32)
    rc = RoutedCoarse(torch.from_numpy(cents), n_super=32, cap_factor=1.0,
                      generator=torch.Generator().manual_seed(3))
    owner, fallback = (t.numpy() for t in routed_tune.placement(rc))
    for s_, row in enumerate(rc.members):
        assert (owner[row[rc.valid[s_]]] == s_).all()
    sup = rc.supers.numpy().astype(np.float64)
    d2 = ((cents[:, None, :].astype(np.float64) - sup[None]) ** 2).sum(-1)
    near = np.argsort(d2, 1, kind="stable")[:, :8]
    want = ~(near == owner[:, None]).any(1)
    assert np.array_equal(fallback, want)
    assert 0 < fallback.sum() < len(cents)


# ---------------------------------------------------------------------------
# marginal_ms and the tools' device
# ---------------------------------------------------------------------------

def test_marginal_ms_is_the_slope_of_bundles(monkeypatch):
    """(t_R - t_1) / (R - 1): a call that costs 2 ms after a fixed 7 ms of
    bundle overhead reads 2 ms."""
    clock = [0.0]

    def fn():
        clock[0] += 0.002

    monkeypatch.setattr(profiling.time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: clock.__setitem__(0, clock[0] + 0.007))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert profiling.marginal_ms(fn, repeat=5) == pytest.approx(2.0)
    assert clock[0] == pytest.approx(3 * 0.009 + 2 * 0.017)


@pytest.mark.parametrize("tool,argv", [
    (assign_ab, []), (coarse_ab, []), (routed_tune, []), (sscal, []),
    (scal, [])])
def test_tools_default_to_cuda_and_raise_without_a_card(tool, argv,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_assign_ab_needs_grouping_scale_and_writes_only_its_cache(
        tmp_path, monkeypatch):
    """Without grouping_scale's centroids the tool exits naming the stage;
    with them it writes <cache>/bench_smoke/assign_ab.json (and the shared
    quantizers beside the centroids), nothing else."""
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="grouping_scale"):
        assign_ab.main(["--smoke", "--device", "cpu", "--nb", "4096"])
    S = tb.sizes(True)
    gs = tmp_path / "bench_smoke" / "grouping_scale"
    gs.mkdir(parents=True)
    rng = np.random.RandomState(2)
    np.save(gs / "centroids.npy",
            (rng.rand(S["GS_NC"], 128) * 60).astype(np.float32))
    record = os.path.join(ROOT, "RESULTS_ASSIGN_AB.json")
    with open(record, "rb") as f:
        before = f.read()
    out = assign_ab.main(["--smoke", "--device", "cpu", "--nb", "4096"])
    with open(record, "rb") as f:
        assert f.read() == before
    assert not os.path.exists(os.path.join(ROOT, "assign_ab.json"))
    assert sorted(os.listdir(tmp_path / "bench_smoke")) == [
        "assign_ab.json", "grouping_scale"]
    assert sorted(os.listdir(gs)) == ["ab.norm_pq", "ab.pq", "centroids.npy"]
    saved = json.load(open(tmp_path / "bench_smoke" / "assign_ab.json"))
    assert saved == json.loads(json.dumps(out))
    assert set(saved["variants"]) == set(assign_ab.VARIANTS)
    assert saved["nb"] == 4096 and saved["nc"] == S["GS_NC"]


def test_routed_tune_as_a_command_at_smoke_sizes(tmp_path, monkeypatch,
                                                 capsys):
    """The tool builds the smoke scale2 into its cache, skips the
    structures of more than nc/2 supers, sweeps the others over the JAX
    rig's ws and, with --result-ws, adds the result overlaps; its last
    stdout line is the JSON record."""
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    out = routed_tune.main(["--smoke", "--device", "cpu", "-B", "32",
                            "--result-ws", "1,2"])
    S = tb.sizes(True)
    assert [(r["n_super"], r["cap_factor"]) for r in out["structures"]] == [
        c for c in routed_tune.CONFIGS if c[0] <= S["S2_NC"] // 2]
    for r in out["structures"]:
        assert [x["w"] for x in r["rows"]] == [
            w for w in routed_tune.WS if w <= r["n_super"]]
        assert all(x["ms"] is not None for x in r["rows"])
    assert [r["w"] for r in out["result_overlap"]][:2] == [1, 2]
    assert out["result_overlap"][-1]["probe_overlap"] == 1.0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["stage"] == "scale2"
    assert os.path.exists(tmp_path / "bench_smoke" / "scale2" / "routed.npz")
