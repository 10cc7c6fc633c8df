"""The port's billion-scale tools end to end on the CPU, as subprocesses at
the BENCH_SMOKE geometry with --device cpu and BENCH_CACHE_DIR in a
temporary directory (mirroring tests/test_tools_1b.py):
ivfhnsw_tpu_torch.tools.build_1b builds its prerequisites and a spill
to half the target, then resumes to the target; tools.search_1b searches
that spill at --shards 4 and 1. Neither touches the JAX package's
.bench_cache/ nor the committed RESULTS_1B.json / RESULTS_SEARCH1B.json."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = ("RESULTS_1B.json", "RESULTS_SEARCH1B.json")


def _stamp():
    """mtimes of the committed records and the listing of .bench_cache/."""
    out = {n: os.path.getmtime(os.path.join(ROOT, n))
           if os.path.exists(os.path.join(ROOT, n)) else None
           for n in RECORDS}
    jc = os.path.join(ROOT, ".bench_cache")
    out[".bench_cache"] = (sorted((f, os.path.getmtime(os.path.join(jc, f)))
                                  for f in os.listdir(jc))
                           if os.path.isdir(jc) else None)
    return out


def _run(tool, cache, *extra):
    env = dict(os.environ, BENCH_SMOKE="1", BENCH_CACHE_DIR=cache)
    r = subprocess.run(
        [sys.executable, "-m", f"ivfhnsw_tpu_torch.tools.{tool}",
         "--device", "cpu", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=540)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("cache"))
    before = _stamp()
    _run("build_1b", cache, "--target", "16384", "--batch", "8192")
    first = json.load(open(os.path.join(cache, "build1b.json")))
    _run("build_1b", cache, "--target", "32768", "--batch", "8192")
    return cache, before, first


def test_build_resumes_to_the_target(built):
    cache, _, first = built
    assert first["processed"] == 16384 and first["resumes"] == 0
    art = json.load(open(os.path.join(cache, "build1b.json")))
    assert art["processed"] == 32768 and art["partial"] is False
    assert art["resumes"] == 1 and art["device"] == "cpu"
    assert art["match_rate"] >= 0.98
    assert [e["batch"] for e in art["drift_series"]] == [0]
    wd = os.path.join(cache, "build1b")
    for f in ("keys.i32", "ids.i32", "norm_codes.u8", "codes.u8",
              "cursor.json", "queries.npy", "gt.npy", "meta.json"):
        assert os.path.exists(os.path.join(wd, f)), f
    cursor = json.load(open(os.path.join(wd, "cursor.json")))
    assert cursor["processed"] == 32768
    assert cursor["sizes"]["codes.u8"] == 32768 * 16
    gt = np.load(os.path.join(wd, "gt.npy"))
    assert gt.shape == (1024, 1) and 0 <= gt.min() and gt.max() < 32768
    for f in ("centroids.npy", "scale3.pq", "scale3.norm_pq"):
        assert os.path.exists(os.path.join(cache, "scale3", f)), f
    assert not os.path.exists(os.path.join(cache, "scale3", "seeds.npy"))


@pytest.mark.parametrize("shards", [4, 1])
def test_search_streams_the_spill(built, shards):
    cache, _, _ = built
    _run("search_1b", cache, "--shards", str(shards))
    out = json.load(open(os.path.join(cache, "search1b.json")))
    assert out["nb"] == 32768 and out["shards"] == shards
    assert out["partial"] is False and len(out["per_shard"]) == shards
    assert out["codes_covered"] == 32768
    # a budget this corpus never reaches + top-1 ground truth: the true
    # neighbour's list is probed for nearly every query
    assert out["recall_at_100"] > 0.9
    assert list(out["combos"]) == ["auto/auto"]


def test_records_and_jax_cache_untouched(built):
    """After both builds and (run in file order) both searches."""
    cache, before, _ = built
    assert _stamp() == before
