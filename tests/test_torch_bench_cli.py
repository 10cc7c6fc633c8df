"""The port's bench tool as a command on the CPU (``python -m
ivfhnsw_tpu_torch.tools.bench --device cpu --smoke``) at the JAX bench's
BENCH_SMOKE sizes, in a temporary BENCH_CACHE_DIR: every JAX field name of
the primary, deep and grouping_scale stages in the last line, no error
field, one cumulative line per stage, a second run loading every stage
from the cache, a stage that fails recorded and ending the command with
exit code 1; the baseline's load gate; the device default; the tool's
imports. Imports no jax.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from ivfhnsw_tpu_torch.tools import bench as tb

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("primary", "deep", "grouping_scale")
# bench.py's field names: _PRIMARY_FIELDS (:420-427), the deep block
# (:2663-2677) and the grouping_scale block (:3079-3110).
JAX_FIELDS = (
    "value", "us_per_query", "us_per_query_single_launch",
    "sustained_pipeline_depth", "end_to_end_us_per_query",
    "recall_at_1", "recall_at_10", "recall_at_100",
    "recall_ceiling_at_1", "recall_ceiling_at_10", "recall_ceiling_at_100",
    "scan_slots_worst_case", "scan_slots_profiled", "vs_baseline",
    "cpu_baseline_us_per_query", "cpu_baseline_recall_at_1",
    "deep_nb", "deep_d", "deep_nc", "deep_qps_nprobe128",
    "deep_us_per_query", "deep_us_per_query_single_launch",
    "deep_pipeline_depth", "deep_recall_at_1", "deep_recall_at_10",
    "deep_recall_at_100", "deep_ceiling_at_1", "deep_ceiling_at_10",
    "deep_ceiling_at_100", "deep_build_seconds",
    "grouping_scale_nb", "grouping_scale_nc", "grouping_scale_nsubc",
    "grouping_scale_qps_nprobe128_mc100k", "grouping_scale_us_per_query",
    "grouping_scale_us_per_query_single_launch",
    "grouping_scale_pipeline_depth", "grouping_scale_recall_at_1",
    "grouping_scale_recall_at_10", "grouping_scale_recall_at_100",
    "grouping_scale_ceiling_at_1", "grouping_scale_ceiling_at_10",
    "grouping_scale_ceiling_at_100", "grouping_scale_qps_pruning_off",
    "grouping_scale_us_per_query_pruning_off",
    "grouping_scale_recall_at_1_pruning_off",
    "grouping_scale_recall_at_10_pruning_off",
    "grouping_scale_build_seconds", "grouping_scale_alpha_pass_seconds",
    "grouping_scale_encode_pass_seconds", "grouping_scale_assignment_mode",
    "grouping_scale_routed_match_rate", "grouping_scale_scan_slots_profiled")
BASELINE = ("cpu_baseline_us_per_query", "cpu_baseline_recall_at_1",
            "vs_baseline")


# ``python -m ivfhnsw_tpu_torch.tools.bench`` that, however it ends, writes
# the names of the modules it imported from jax, ivfhnsw_tpu or the root
# bench to the file named by BENCH_MODULES_OUT.
RUN_TOOL = """
import json, os, runpy, sys
try:
    runpy.run_module("ivfhnsw_tpu_torch.tools.bench", run_name="__main__",
                     alter_sys=True)
finally:
    with open(os.environ["BENCH_MODULES_OUT"], "w") as f:
        json.dump(sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "ivfhnsw_tpu", "bench")),
                  f)
"""


def _tool(cache, *args):
    env = dict(os.environ, BENCH_CACHE_DIR=str(cache),
               OMP_NUM_THREADS=str(min(8, os.cpu_count() or 1)),
               BENCH_MODULES_OUT=str(cache / "modules.json"))
    env.pop("BENCH_SMOKE", None)
    return subprocess.run(
        [sys.executable, "-c", RUN_TOOL, "--device", "cpu", "--smoke",
         *args], capture_output=True, text=True, timeout=900, env=env,
        cwd=REPO)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    cache = tmp_path_factory.mktemp("bench")
    r = _tool(cache, "--stages", ",".join(STAGES))
    assert r.returncode == 0, r.stderr[-3000:]
    return cache, r


def test_record_holds_every_jax_field(smoke_run):
    cache, r = smoke_run
    lines = [json.loads(ln) for ln in r.stdout.strip().splitlines()]
    assert len(lines) == len(STAGES)
    assert [ln["partial_run"] for ln in lines] == [True, True, False]
    rec = lines[-1]
    assert rec["stages_done"] == list(STAGES)
    assert [k for k in JAX_FIELDS if k not in rec] == []
    assert not [k for k in rec if k.endswith("_error")]
    assert rec["device"] == "cpu" and rec["backend"] == "cpu"
    assert rec["torch"] == torch.__version__ and rec["smoke"] is True
    with open(cache / "bench_smoke" / "last_result.json") as f:
        assert json.load(f) == rec
    for k, v in rec.items():
        if k in BASELINE:       # a number, or None beside the refusal
            assert (v is None) == ("cpu_baseline_refused" in rec), k
        elif k in JAX_FIELDS and not k.endswith("assignment_mode"):
            assert isinstance(v, (int, float)) and v >= 0, (k, v)
    for pre in ("recall_ceiling_at_", "deep_ceiling_at_",
                "grouping_scale_ceiling_at_"):
        assert 0 < rec[pre + "1"] <= rec[pre + "10"] <= rec[pre + "100"] <= 1
    assert rec["deep_d"] == 96 and rec["grouping_scale_nsubc"] == 16


def test_second_run_loads_the_cache(smoke_run, monkeypatch, capsys):
    """Every builder is exists()-gated: run 2 (the tool's main, in this
    process) computes no index and gets the same recalls."""
    cache, r1 = smoke_run
    monkeypatch.setenv("BENCH_CACHE_DIR", str(cache))
    monkeypatch.delenv("BENCH_SMOKE", raising=False)
    b = tb.main(["--device", "cpu", "--smoke", "--stages",
                 "deep,grouping_scale"])
    out, err = capsys.readouterr()
    assert "built in" not in err and "streaming" not in err
    assert json.loads(out.splitlines()[-1]) == b
    a = json.loads(r1.stdout.splitlines()[-1])
    for k in ("deep_recall_at_10", "deep_ceiling_at_10",
              "grouping_scale_recall_at_10", "grouping_scale_ceiling_at_100",
              "deep_build_seconds"):
        assert a[k] == b[k], k


def test_failing_stage_exits_non_zero(smoke_run, tmp_path):
    """A primary index file that cannot be read fails the stage: the
    command exits 1, and its one record line holds ``primary_error`` and
    no measured stage."""
    cache, _ = smoke_run
    bad = tmp_path / "bad"
    (bad / "bench_smoke").mkdir(parents=True)
    src = cache / "bench_smoke" / "primary"
    (bad / "bench_smoke" / "primary").mkdir()
    # the same corpus version, so that the run keeps the corrupt file
    (bad / "bench_smoke" / "corpus_version").write_bytes(
        (cache / "bench_smoke" / "corpus_version").read_bytes())
    for f in os.listdir(src):
        data = (src / f).read_bytes()
        (bad / "bench_smoke" / "primary" / f).write_bytes(
            data[:100] if f == "bench.index" else data)
    r = _tool(bad, "--stages", "primary")
    assert r.returncode == 1
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["primary_error"] and rec["stages_done"] == []
    assert "value" not in rec and "us_per_query" not in rec


def test_baseline_gate_refuses_without_a_number(tmp_path, monkeypatch):
    """A host whose load stays above the gate gets a refusal, no number,
    and nothing cached."""
    from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
    import numpy as np
    rng = np.random.RandomState(0)
    x = rng.randn(3000, 16).astype(np.float32)
    idx = IVFADCIndex(IndexConfig(d=16, nc=16, code_size=4), "cpu")
    g = torch.Generator().manual_seed(0)
    idx.train_centroids(g, x, niter=2)
    idx.train_pq(g, x, pq_niter=2)
    idx.add_batch(x)
    monkeypatch.setattr(os, "getloadavg", lambda: (3.0, 3.0, 3.0))
    monkeypatch.setattr(tb.time, "sleep", lambda s: None)
    monkeypatch.setattr(tb, "LOAD_WAIT_S", 0.0)
    out = tb.measure_cpu_baseline(idx, x[:20], np.zeros((20, 1), np.int64),
                                  tb.sizes(True), str(tmp_path))
    assert set(out) == {"refused"} and "3.00" in out["refused"]
    assert os.listdir(tmp_path) == []
    fields = tb._baseline_fields(out, "", BASELINE, 100.0)
    assert all(fields[k] is None for k in BASELINE)


def test_unknown_stage_and_default_device(monkeypatch):
    with pytest.raises(SystemExit):
        tb.main(["--stages", "nosuch", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main(["--stages", "deep"])


def test_tool_imports_neither_jax_nor_the_jax_bench(smoke_run):
    """No import line of the tool names jax, ivfhnsw_tpu or the root
    bench, and the smoke command's whole run imported none of them."""
    with open(tb.__file__) as f:
        src = f.read()
    pat = (r"^\s*(import|from)\s+(jax\b|ivfhnsw_tpu\b(?!_torch)|bench\b)"
           r"|import\s+ivfhnsw_tpu\s*$")
    assert not re.search(pat, src, re.M)
    cache, _ = smoke_run
    with open(cache / "modules.json") as f:
        assert json.load(f) == []
