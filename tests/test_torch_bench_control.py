"""The port bench tool's run control on the CPU, at the BENCH_SMOKE sizes in
a temporary BENCH_CACHE_DIR: the wall-clock budget and its skip markers
(no field of a skipped stage), the stage estimates and the warm reserve
held to the root bench.py's on the same cache files, a stage that raises,
SIGTERM / SIGINT after the first stage line, the cache lock and the
corpus-version wipe, tools/warm_cache.py before a warm run and
tools/scale4_eval.py against eval_scale4.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from ivfhnsw_tpu_torch.tools import bench as tb
from ivfhnsw_tpu_torch.tools import scale4_eval, warm_cache

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jb  # noqa: E402  (the root bench.py, as test_docs.py has it)

# The record's own keys: everything else is a stage's field.
RECORD_KEYS = {"metric", "unit", "backend", "device", "torch", "cuda",
               "smoke", "corpus_version", "cache_lock_held",
               "budget_seconds", "host_nproc", "host_loadavg_1m",
               "launch_roundtrip_ms", "stages_done", "stage_keys",
               "skipped_stages", "partial_run", "bench_wall_seconds",
               "recorded_at", "terminated_by_signal", "terminated_in_stage"}
MARKER_KEYS = {"stage", "cached", "est_seconds", "budget_left_seconds",
               "reason"}
MARGIN = 20.0   # budget beyond scale2's warm seconds: below any cold stage


def _env(cache, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("BENCH_SMOKE", "BENCH_BUDGET_S", "BENCH_STAGES")}
    return dict(env, BENCH_CACHE_DIR=str(cache),
                OMP_NUM_THREADS=str(min(4, os.cpu_count() or 1)), **extra)


def _tool(cache, *args, **extra):
    return subprocess.run(
        [sys.executable, "-m", "ivfhnsw_tpu_torch.tools.bench", "--device",
         "cpu", "--smoke", *args], capture_output=True, text=True,
        timeout=600, env=_env(cache, **extra), cwd=REPO)


@pytest.fixture
def smoke_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BENCH_SMOKE", raising=False)
    monkeypatch.delenv("BENCH_BUDGET_S", raising=False)
    monkeypatch.delenv("BENCH_STAGES", raising=False)
    return tmp_path / "bench_smoke"


@pytest.mark.parametrize("how", ["flag", "env"])
def test_zero_budget_skips_every_stage(tmp_path, how):
    """Budget 0 (``--budget-s 0`` or BENCH_BUDGET_S=0): every stage skipped
    with its marker, no stage field, one parseable line a stage, rc 0."""
    r = (_tool(tmp_path, "--budget-s", "0") if how == "flag"
         else _tool(tmp_path, BENCH_BUDGET_S="0"))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.strip().splitlines()]
    assert len(lines) == len(tb.STAGES)
    rec = lines[-1]
    assert rec["partial_run"] is False and rec["stages_done"] == []
    assert [m["stage"] for m in rec["skipped_stages"]] == list(tb.STAGES)
    for m in rec["skipped_stages"]:
        assert set(m) == MARKER_KEYS, m
        assert m["reason"] == "wall-clock budget"
        # a report-only stage has nothing to build: priced warm
        assert m["cached"] == (not tb.NEED[m["stage"]].probe)
        assert m["budget_left_seconds"] == 0 and m["est_seconds"] > 0
    assert set(rec) <= RECORD_KEYS, set(rec) - RECORD_KEYS
    assert rec["budget_seconds"] == 0.0
    with open(tmp_path / "bench_smoke" / "last_result.json") as f:
        assert json.load(f) == rec


def test_stage_filter_marks_the_rest(smoke_cache, capsys):
    rec = tb.main(["--device", "cpu", "--smoke", "--stages", "search_1b"])
    assert rec["stages_done"] == ["search_1b"]
    assert rec["skipped_stages"] == [
        {"stage": s, "reason": "stage filter"} for s in tb.STAGES
        if s != "search_1b"]
    assert set(rec["stage_keys"]["search_1b"]) == (
        set(rec) - RECORD_KEYS)
    assert len(capsys.readouterr().out.strip().splitlines()) == 1


def _layout(cache, files):
    for p in files:
        os.makedirs(os.path.dirname(os.path.join(cache, p)) or cache,
                    exist_ok=True)
        open(os.path.join(cache, p), "w").close()


# Cache states over the port's own file names: empty, partly built stages
# (the discount files), whole stages (their probe files).
STATES = {
    "empty": (),
    "partial": ("scale3sl/centroids.npy", "scale3sl/scale3sl.pq",
                "scale2/centroids.npy", "grouping_scale/gs.index"),
    "s3sl_index": ("scale3sl/centroids.npy", "scale3sl/scale3sl.pq",
                   "scale3sl/scale3sl.index"),
    "warm": tuple(p for n in ("scale3sl", "scale2", "deep", "scale4")
                  for p in tb.NEED[n].probe) + ("scale3sl/centroids.npy",),
}


@pytest.mark.parametrize("state", list(STATES))
def test_estimates_match_bench_py(tmp_path, monkeypatch, state):
    """estimate_stage_need of every stage equals bench.py's on the same
    cache files, with the port's probes, estimates and discounts."""
    _layout(tmp_path, STATES[state])
    monkeypatch.setattr(jb, "CACHE", str(tmp_path))
    for name, n in tb.NEED.items():
        got = tb.estimate_stage_need(str(tmp_path), n.probe, n.fresh,
                                     n.warm, n.discounts)
        want = jb.estimate_stage_need(list(n.probe), n.fresh, n.warm,
                                      list(n.discounts))
        assert got == want, (name, got, want)
        assert got[1] >= n.warm


@pytest.mark.parametrize("state", list(STATES))
def test_warm_reserve_matches_bench_py(tmp_path, monkeypatch, state):
    """warm_reserve equals bench.py's (given the port's RESERVABLE_WARM)
    for every excluded stage and every decided set along the order."""
    _layout(tmp_path, STATES[state])
    monkeypatch.setattr(jb, "CACHE", str(tmp_path))
    monkeypatch.setattr(jb, "RESERVABLE_WARM", tb.RESERVABLE_WARM)
    names = [n for n, _, _ in tb.RESERVABLE_WARM]
    for i in range(len(names) + 1):
        decided = set(names[:i])
        for ex in names + ["primary"]:
            assert (tb.warm_reserve(str(tmp_path), ex, decided)
                    == jb.warm_reserve(ex, decided)), (ex, decided)


def test_estimates_are_the_cards():
    """Every estimate is the port's own: no fresh or warm seconds of
    bench.py's call sites (its TPU estimates) among them; a fresh stage
    costs at least its warm run and its discounts."""
    tpu = {900, 250, 800, 200, 1400, 300, 1000, 7100, 700, 12100, 4200, 600,
           500, 5500, 1700, 2500, 4000, 4400}
    for name, n in tb.NEED.items():
        assert not {n.fresh, n.warm} & tpu, name
        assert n.fresh >= n.warm > 0, name
        assert sum(s for _, s in n.discounts) <= n.fresh, name
    assert tb.NEED["scale4"].fresh > tb.NEED["scale3sl"].fresh
    assert tb.NEED["scale4"].discounts[:3] == tb.NEED["scale3sl"].discounts
    # scale4 from an empty cache is scale3sl and then its extension, and
    # the card ran the two whole in one call under --budget-s 3300
    s3, s4 = tb.NEED["scale3sl"], tb.NEED["scale4"]
    assert s4.fresh == pytest.approx(s3.fresh + s4.discounts[-1][1])
    assert s4.fresh < 3300


def test_budget_charges_the_warm_reserve(tmp_path):
    """A cold stage is charged the pending warm stages' seconds unless the
    stages were named; a cached one never is."""
    _layout(tmp_path, tb.NEED["scale2"].probe)
    w2 = tb.NEED["scale2"].warm
    need_p = tb.NEED["primary"].fresh
    left = need_p + w2 / 2
    m = tb.budget_marker("primary", str(tmp_path), left, False, set())
    assert m["warm_reserve_seconds"] == w2 and m["cached"] is False
    assert tb.budget_marker("primary", str(tmp_path), left, True,
                            set()) is None
    assert tb.budget_marker("scale2", str(tmp_path), w2, False,
                            set()) is None
    d = {"scale2"}
    assert tb.budget_marker("primary", str(tmp_path), left, False, d) is None


def test_budget_admits_only_the_warm_stage(smoke_cache, capsys):
    """scale2 warmed first; then a budget of its warm seconds runs it and
    the report stages and skips every cold stage, none leaving a field."""
    tb.main(["--device", "cpu", "--smoke", "--stages", "scale2"])
    w2 = tb.NEED["scale2"].warm
    assert MARGIN < min(n.fresh for n in tb.NEED.values() if n.probe)
    rec = tb.main(["--device", "cpu", "--smoke", "--budget-s",
                   str(w2 + MARGIN)])
    # build_1b (a file read) runs if scale2 left it a second
    assert rec["stages_done"][:2] == ["search_1b", "scale2"]
    assert set(rec["stages_done"]) <= {"search_1b", "scale2", "build_1b"}
    skipped = {m["stage"]: m for m in rec["skipped_stages"]}
    assert set(skipped) == set(tb.STAGES) - set(rec["stages_done"])
    assert all(m["cached"] is False for m in skipped.values())
    assert skipped["primary"]["warm_reserve_seconds"] == w2
    assert "warm_reserve_seconds" not in skipped["scale3"]
    measured = set(rec) - RECORD_KEYS
    assert measured == {k for s in rec["stages_done"]
                        for k in rec["stage_keys"][s]}
    for s in skipped:
        assert f"{s}_stage_seconds" not in rec
    assert rec["scale2_ceiling_seconds"] is None     # read from the cache
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == rec


def test_raising_stage_records_its_error(smoke_cache, monkeypatch, capsys):
    """A stage that raises: ``<stage>_error`` (200 characters), left out of
    stages_done, the next stage runs, and the exit code is 1."""
    def boom(S, cache):
        raise RuntimeError("x" * 300)

    monkeypatch.setitem(tb.STAGES, "search_1b", (None, boom))
    assert tb.cli(["--device", "cpu", "--smoke", "--stages",
                   "search_1b,build_1b"]) == 1
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    rec = lines[-1]
    assert rec["search_1b_error"] == ("RuntimeError: " + "x" * 300)[:200]
    assert rec["stages_done"] == ["build_1b"]
    assert not [k for k in rec if k.startswith("search_1b_")
                and k != "search_1b_error"]
    assert [ln["partial_run"] for ln in lines] == [True, False]
    assert "search_1b_error" in lines[0] and lines[0]["stages_done"] == []
    assert tb.cli(["--device", "cpu", "--smoke", "--stages", "build_1b"]) \
        == 0


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_signal_flushes_the_record(tmp_path, sig):
    """A signal once the second stage has begun: the last stdout line
    parses, carries terminated_by_signal and the stage it cut, equals
    last_result.json, and the exit code is 128 + the signal."""
    err = tmp_path / "err.txt"
    with open(err, "w") as f:
        p = subprocess.Popen(
            [sys.executable, "-m", "ivfhnsw_tpu_torch.tools.bench",
             "--device", "cpu", "--smoke", "--stages",
             "primary,deep,grouping_scale"], stdout=subprocess.PIPE,
            stderr=f, text=True, env=_env(tmp_path), cwd=REPO)
    try:
        first = json.loads(p.stdout.readline())
        for _ in range(600):
            if "streaming" in err.read_text():    # deep is building
                break
            time.sleep(0.05)
        p.send_signal(sig)
        rest = p.stdout.read()
        rc = p.wait(timeout=300)
    finally:
        p.kill()
    assert first["stages_done"] == ["primary"]
    assert rc == 128 + sig
    lines = rest.strip().splitlines()
    assert len(lines) == 1
    last = json.loads(lines[0])
    assert last["terminated_by_signal"] == sig
    assert last["terminated_in_stage"] == "deep"
    assert last["partial_run"] is True
    assert last["stages_done"] == ["primary"]
    assert not [k for k in last if k.startswith("deep_")]
    with open(tmp_path / "bench_smoke" / "last_result.json") as f:
        assert json.load(f) == last


def test_signal_inside_a_stage_flushes_to_stdout(smoke_cache, monkeypatch,
                                                 capsys):
    """A signal while a stage's builder runs (its output sent to stderr):
    one flush, on stdout, and SystemExit(143)."""
    def build(S, device, cache):
        os.kill(os.getpid(), signal.SIGTERM)
        os.kill(os.getpid(), signal.SIGTERM)     # a second one is ignored
        raise AssertionError("not reached")

    monkeypatch.setitem(tb.STAGES, "scale", (build, None))
    with pytest.raises(SystemExit) as e:
        tb.main(["--device", "cpu", "--smoke", "--stages",
                 "scale,build_1b"])
    assert e.value.code == 143
    out, err = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.strip().splitlines()]
    assert len(lines) == 1 and lines[0]["stages_done"] == []
    assert lines[0]["terminated_in_stage"] == "scale"
    assert lines[0]["terminated_by_signal"] == signal.SIGTERM
    assert err.count("flushing the record") == 1
    assert signal.getsignal(signal.SIGTERM) is not signal.SIG_IGN


def test_lock_guards_the_version_wipe(tmp_path, monkeypatch):
    """A cache of another corpus version is wiped only by a run that holds
    the lock; a second run waits BENCH_LOCK_WAIT_S and then leaves it."""
    import fcntl
    cache = tmp_path / "c"
    cache.mkdir()
    (cache / "corpus_version").write_text("0")
    (cache / "stale.npy").write_text("old")
    (cache / "last_result.json").write_text("{}")
    monkeypatch.setenv("BENCH_LOCK_WAIT_S", "0.3")
    other = open(cache / ".lock", "w")
    fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
    lock, held = tb.take_cache(str(cache))
    lock.close()
    assert held is False
    assert (cache / "stale.npy").exists()
    assert (cache / "corpus_version").read_text() == "0"
    other.close()
    lock, held = tb.take_cache(str(cache))
    assert held is True
    assert sorted(os.listdir(cache)) == [".lock", "corpus_version",
                                         "last_result.json"]
    assert (cache / "corpus_version").read_text() == str(tb.CORPUS_VERSION)
    (cache / "kept.npy").write_text("new")
    lock.close()
    lock, held = tb.take_cache(str(cache))      # same version: kept
    lock.close()
    assert held and (cache / "kept.npy").exists()


def test_warm_cache_then_warm_bench_and_scale4_eval(smoke_cache, capsys):
    """warm_cache builds scale3sl and scale4 and writes their ceilings; a
    second warm_cache finds both; a bench run prices both warm and reads
    the cached ceilings; scale4_eval's eval.json holds eval_scale4's
    fields, equal to the stage's but for the measured times."""
    out = warm_cache.main(["--device", "cpu", "--smoke", "scale3sl",
                           "scale4"])
    assert [(o["stage"], o["build"], o["ceiling"]) for o in out] == [
        ("scale3sl", "built", "computed"), ("scale4", "built", "computed")]
    assert (smoke_cache / "corpus_version").read_text() == "1"
    again = warm_cache.main(["--device", "cpu", "--smoke", "scale3sl",
                             "scale4"])
    assert [(o["build"], o["ceiling"]) for o in again] == [
        ("cached", "cached")] * 2
    for n in ("scale3sl", "scale4"):
        assert tb.estimate_stage_need(str(smoke_cache), tb.NEED[n].probe,
                                      1e9, 7.0)[0]
    rec = tb.main(["--device", "cpu", "--smoke", "--stages",
                   "scale3sl,scale4", "--budget-s",
                   str(tb.NEED["scale3sl"].warm + tb.NEED["scale4"].warm
                       + MARGIN)])
    assert rec["stages_done"] == ["scale3sl", "scale4"]
    assert rec["scale3sl_ceiling_seconds"] is None
    assert rec["scale4_ceiling_seconds"] is None
    ev = scale4_eval.run(tb.sizes(True), torch.device("cpu"),
                         str(smoke_cache), smoke=True)
    with open(smoke_cache / "scale4" / "eval.json") as f:
        assert json.load(f) == ev
    stage = set(rec["stage_keys"]["scale4"]) - {"scale4_stage_seconds"}
    assert set(ev) - {"load_seconds", "timed_seconds", "device",
                      "recorded_at"} == stage
    for k in stage - set(scale4_eval.TIMED):
        assert ev[k] == rec[k], k
    assert ev["device"] == "cpu"
    capsys.readouterr()


def test_scale4_eval_refuses_without_a_build(smoke_cache):
    with pytest.raises(SystemExit, match="no scale4 build"):
        scale4_eval.run(tb.sizes(True), torch.device("cpu"),
                        str(smoke_cache), smoke=True)


def test_tools_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (warm_cache.main, scale4_eval.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(SystemExit):
        warm_cache.main(["--device", "cpu", "nosuch"])
