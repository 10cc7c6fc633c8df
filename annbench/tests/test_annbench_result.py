"""The result line and the command's refusals."""

import os
import subprocess
import sys
import time

import pytest
import torch

from annbench import harness
from annbench.tests.toy import bench
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_result_keys(toy):
    out = harness.run_cell("sift1b-ivfadc16.add-1m", 5, 0.2, False, "cpu",
                           bench(), time.perf_counter(), log=lambda s: None,
                           base=toy)
    assert list(out) == KEYS
    assert set(out["metrics"]) == {"add_rows_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "annbench/run.py", "--workload",
                        "sift1b-ivfadc16.batch-10k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_roofline_count_same_for_wide_and_two_phase(toy, monkeypatch):
    """The scan-and-top-k roofline counts the benchmark's own work: the
    same under the wide and the two-phase top-k of one toy schedule, where
    the program's padded outputs differ."""
    from annbench.trace import Trace
    metric = harness.load_metric("scan_topk_roofline.search")
    seen = {}

    def traced_trace(ctx_run):
        ev = [{"ph": "X", "cat": "user_annotation", "name": "annbench.step",
               "ts": i * 100, "dur": 50} for i in range(1)]
        ev += [{"ph": "X", "cat": "kernel", "name": "adc_scan_slots_x",
                "ts": i * 100 + 10, "dur": 1000} for i in range(1)]
        return Trace(ev)

    orig_ctx = harness.MetricCtx

    for mode in ("wide", "twophase"):
        monkeypatch.setattr(IVFADCIndex, "scan_topk", mode, raising=False)
        outs = {}

        def capture(run, trace, host, ref, chunks, device=None, outs=outs):
            ctx = orig_ctx(run, traced_trace(run), host, ref, chunks, device)
            outs["value"] = metric.read(ctx)
            return ctx
        monkeypatch.setattr(harness, "MetricCtx", capture)
        b = bench()
        out = harness.run_cell("sift1b-ivfadc16.batch-10k", 9, 3.0, True,
                               "cpu", b, time.perf_counter(),
                               log=lambda s: None, base=toy)
        assert out["correct"]
        seen[mode] = outs["value"]
    assert seen["wide"] is not None
    assert seen["wide"] == seen["twophase"]


@pytest.mark.cuda
def test_card_run(cuda_device, toy):
    """On a card: a toy run through the kernels, correct, with its device."""
    out = harness.run_cell("sift1b-ivfadc16.batch-10k", 4, 0.5, False,
                           cuda_device, bench(), time.perf_counter(),
                           log=lambda s: None, base=toy)
    assert out["correct"]
    assert out["device"]["platform"] == "gpu"
