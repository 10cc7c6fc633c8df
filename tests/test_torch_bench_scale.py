"""The bench tool's last stages (ivfhnsw_tpu_torch/tools/bench.py:
scale3sl, scale4, scale3 and the report-only build_1b / search_1b) on the
CPU at the JAX bench's BENCH_SMOKE sizes: the sizes against bench.py's
constants; scale4's store against one build over its whole stream, bit for
bit; its merged ground truth against a float64 brute force; scale4 from a
cached scale3sl against scale4 from a fresh one; the report stages without
their artifacts; the stage names against bench.py's STAGES_ALL, read from
its text.

Tolerance: the ground truth's distances against float64 within rtol 1e-4 /
atol 1e-3 (tests/test_pallas_adc.py:42-46), so that labels may differ only
where two rows tie.
"""

import builtins
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import bench
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.tools import bench as tb
from ivfhnsw_tpu_torch.tools import scale3

torch.set_num_threads(4)
RTOL, ATOL = 1e-4, 1e-3
CPU = torch.device("cpu")
S = tb.sizes(True)
NEW = ("S3_NB", "S3_NC", "S3_NQ", "S3_NPROBE", "S3_MC", "S3SL_NB",
       "S3SL_NC", "S3SL_NQ", "S3SL_NCLS", "S3SL_SIGMA", "S3SL_SKEW",
       "S3SL_SWEEP", "S4_NB")


@pytest.mark.parametrize("smoke", [False, True])
def test_stage_sizes_are_the_jax_bench_constants(smoke, monkeypatch):
    if smoke:
        monkeypatch.setenv("BENCH_SMOKE", "1")
        spec = importlib.util.spec_from_file_location(
            "bench_scale_smoke_sizes", bench.__file__)
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
    else:
        ref = bench
    port = tb.sizes(smoke)
    assert {k: port[k] for k in NEW} == {k: getattr(ref, k) for k in NEW}
    # the densities the stages exist for: 128 and 256 codes a list
    if not smoke:
        assert port["S3SL_NB"] // port["S3SL_NC"] == 128
        assert port["S4_NB"] // port["S3SL_NC"] == 256


def _store(idx):
    st = idx._ensure_store()
    return {k: np.asarray(getattr(st, k)) for k in
            ("codes", "norm_codes", "ids", "list_offsets")}


def _assert_same_store(a, b):
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """scale4 built in one go (scale3sl built inside it)."""
    cache = str(tmp_path_factory.mktemp("s4fresh"))
    idx, q, gt, meta = tb.build_scale4(S, CPU, cache)
    return cache, idx, q, gt, meta


def test_scale4_store_is_one_build_over_the_whole_stream(fresh):
    cache, idx, q, gt, meta = fresh
    sd = os.path.join(cache, "scale3sl")
    one = IVFADCIndex(IndexConfig(d=128, nc=S["S3SL_NC"], code_size=16), CPU)
    one.set_centroids(np.load(os.path.join(sd, "centroids.npy")))
    one.load_quantizers(os.path.join(sd, "scale3sl.pq"),
                        os.path.join(sd, "scale3sl.norm_pq"))
    if meta["assignment_mode"] == "routed":
        one.enable_fast_assign(
            w=4, n_super=min(2048, one.nc // 4),
            generator=torch.Generator().manual_seed(tb.S3SL_ROUTED["seed"]))
    corpus = tb.SiftStream(CPU, S)
    bs = min(tb.BATCH, S["S3SL_NB"])
    for bi in range(S["S4_NB"] // bs):
        one.add_batch_device(corpus.gen(tb.S3SL_SEEDS["base"] + bi, bs),
                             np.arange(bi * bs, (bi + 1) * bs,
                                       dtype=np.int32))
    one.finalize()
    assert idx.store.ntotal == S["S4_NB"] == idx.builder.ntotal
    _assert_same_store(_store(idx), _store(one))
    # scale4's store is scale3sl's plus the extension: every list keeps
    # scale3sl's ids first, in their order
    sl = IVFADCIndex(one.config, CPU)
    tb._load_streamed(sl, tb._stream_paths(sd, "scale3sl"))
    a, b = _store(sl), _store(idx)
    for c in range(sl.nc):
        ids_a = a["ids"][a["list_offsets"][c]:a["list_offsets"][c + 1]]
        ids_b = b["ids"][b["list_offsets"][c]:b["list_offsets"][c + 1]]
        assert np.array_equal(ids_b[:len(ids_a)], ids_a)
        assert (ids_b[len(ids_a):] >= S["S3SL_NB"]).all()


def test_scale4_ground_truth_is_the_brute_force_top1(fresh):
    _, _, q, gt, _ = fresh
    corpus = tb.SiftStream(CPU, S)
    bs = min(tb.BATCH, S["S3SL_NB"])
    base = np.concatenate([
        corpus.gen(tb.S3SL_SEEDS["base"] + bi, bs).numpy()
        for bi in range(S["S4_NB"] // bs)]).astype(np.float64)
    d2 = ((q.astype(np.float64)[:, None, :] - base[None]) ** 2).sum(-1)
    best = d2.min(1)
    assert gt.shape == (S["S3SL_NQ"], 1)
    got = d2[np.arange(len(q)), gt[:, 0]]
    np.testing.assert_allclose(got, best, rtol=RTOL, atol=ATOL)
    assert (gt[:, 0] == d2.argmin(1)).mean() > 0.95


def test_scale4_from_a_cached_scale3sl_equals_a_fresh_one(fresh, tmp_path):
    _, idx, _, gt, meta = fresh
    cache = str(tmp_path)
    sl = tb.build_scale3sl(S, CPU, cache)[0]
    sl.release_device()
    del sl
    idx2, _, gt2, meta2 = tb.build_scale4(S, CPU, cache)
    assert idx2.store.ntotal == S["S4_NB"] == idx2.builder.ntotal
    _assert_same_store(_store(idx), _store(idx2))
    assert np.array_equal(gt, gt2)
    assert meta2["assignment_mode"] == meta["assignment_mode"]
    # and scale4 itself from the cache: the builder holds S4_NB rows once
    idx3 = tb.build_scale4(S, CPU, cache)[0]
    assert idx3.builder.ntotal == S["S4_NB"]
    _assert_same_store(_store(idx), _store(idx3))


def test_stage_records_on_the_smoke_indexes(fresh):
    cache, idx, q, gt, meta = fresh
    f = tb.eval_scale4(idx, q, gt, meta, S, cache, True)
    assert f["scale4_nb"] == S["S4_NB"] and f["scale4_hbm_in_use_gb"] is None
    assert 0 < f["scale4_ceiling_at_1"] <= f["scale4_ceiling_at_10"] <= 1
    assert f["scale4_recall_at_10"] <= f["scale4_ceiling_at_10"] + 0.1
    sl = tb.build_scale3sl(S, CPU, cache)
    f = tb.eval_scale3sl(*sl, S, cache, True)
    assert [(c["nprobe"], c["max_codes"]) for c in f["scale3sl_curve"]] \
        == list(S["S3SL_SWEEP"])
    assert [c["nprobe"] for c in f["scale3sl_r100_nprobe_curve"]] == [
        210, 256, 384, 512]
    for k in (1, 10, 100):
        assert 0 <= f[f"scale3sl_recall_unlimited_at_{k}"] <= 1
    assert "scale3sl_assign_ab" not in f and "scale3sl_coarse_ab" not in f


def test_report_stages_without_artifacts_say_absent(tmp_path, monkeypatch):
    """No build1b.json / search1b.json in the tools' cache: every field
    None, the source "absent", and no RESULTS_*.json or .bench_cache/ path
    opened or probed."""
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    seen = []
    real_open, real_exists = builtins.open, os.path.exists
    monkeypatch.setattr(builtins, "open",
                        lambda p, *a, **k: (seen.append(str(p)),
                                            real_open(p, *a, **k))[1])
    monkeypatch.setattr(os.path, "exists",
                        lambda p: (seen.append(str(p)), real_exists(p))[1])
    b = tb.report_build_1b(S, str(tmp_path))
    s = tb.report_search_1b(S, str(tmp_path))
    monkeypatch.undo()
    assert b["build_1b_source"] == "absent" == s["search_1b_source"]
    assert all(v is None for k, v in b.items() if k != "build_1b_source")
    assert s["search_1b_per_shard_us_per_query"] == []
    assert all(v is None for k, v in s.items()
               if k not in ("search_1b_source",
                            "search_1b_per_shard_us_per_query"))
    assert seen and not [p for p in seen if "RESULTS_" in p
                         or ".bench_cache" + os.sep in p]
    assert all(p.startswith(str(tmp_path)) for p in seen)


def test_report_stages_read_the_tools_records(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    with open(tmp_path / "build1b.json", "w") as f:
        json.dump({"processed": 32768, "build_seconds": 3.5,
                   "vectors_per_sec": 9362.3, "fraction_of_1b": 0.0,
                   "resumes": 1, "partial": False,
                   "drift_series": [{"batch": 0, "match_rate": 0.99},
                                    {"batch": 32, "match_rate": 0.985}]}, f)
    with open(tmp_path / "search1b.json", "w") as f:
        json.dump({"nb": 32768, "shards": 4, "shards_done": 4,
                   "recall_at_1": 0.5, "per_shard": [{"us_per_query": 2.0},
                                                     {"us_per_query": 3.0}]},
                  f)
    b = tb.report_build_1b(S, str(tmp_path))
    s = tb.report_search_1b(S, str(tmp_path))
    assert b["build_1b_source"] == "cache" == s["search_1b_source"]
    assert b["build_1b_vectors"] == 32768 and b["build_1b_resumes"] == 1
    assert b["build_1b_drift_min_match_rate"] == 0.985
    assert s["search_1b_shards"] == 4 and s["search_1b_recall_at_1"] == 0.5
    assert s["search_1b_per_shard_us_per_query"] == [2.0, 3.0]


def _stages_all():
    """bench.py's STAGES_ALL, read from its text."""
    with open(os.path.join(scale3.ROOT, "bench.py")) as f:
        m = re.search(r"^STAGES_ALL = \((.*?)\)", f.read(), re.M | re.S)
    return re.findall(r'"(\w+)"', m.group(1))


def test_stages_are_stages_all_in_its_order():
    names = _stages_all()
    assert len(names) == 12 and list(tb.STAGES) == names
    _, picked = tb.parse(["--stages", ",".join(reversed(names))])
    assert picked == names
    for name in names:
        assert tb.parse(["--stages", name])[1] == [name]
