"""Kernel attribution and the device's busy share, on a recorded toy trace
in the profiler's Chrome format."""

from annbench.trace import STEP, Trace

P = "/ck/ivfhnsw_tpu_torch/"


def frame(path, func, ts, dur, tid=1):
    return {"ph": "X", "cat": "python_function", "name": f"{P}{path}(10): {func}",
            "ts": ts, "dur": dur, "tid": tid}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def toy_events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": STEP, "ts": 0,
           "dur": 100, "tid": 1},
          frame("models/ivfadc.py", "search_device", 0, 100),
          frame("ops/cuda/adc_scan.py", "scan_inputs", 1, 60),
          frame("ops/cuda/adc_scan.py", "select_probes", 2, 20),
          frame("ops/distances.py", "streaming_topk_l2", 3, 18),
          frame("ops/topk.py", "topk_smallest", 10, 5),
          frame("ops/cuda/adc_scan.py", "build_luts", 30, 10),
          frame("ops/pq.py", "_pq_ip_luts", 31, 5),
          frame("ops/cuda/adc_scan.py", "scan_topk", 70, 25),
          frame("ops/cuda/adc_scan.py", "topk_labels", 80, 10),
          frame("ops/topk.py", "binned_topk_smallest", 81, 8),
          launch(1, 5), kernel("sm90_xmma_gemm_f32f32", 1, 110, 400),
          launch(2, 12), kernel("gatherTopK", 2, 510, 100),
          launch(3, 32), kernel("sm90_xmma_gemm_f32f32", 3, 610, 50),
          launch(4, 82), kernel("gatherTopK", 4, 700, 80),
          # no launch record: falls back to its name
          kernel("adc_scan_slots_kernel_block", 99, 660, 40),
          # launched outside the step
          launch(5, 150), kernel("elementwise", 5, 900, 10)]
    return ev


def test_attribution_by_launching_frame():
    t = Trace(toy_events())
    layer = {(op[0], op[1]): op[4] for op in t.ops}
    assert layer[("sm90_xmma_gemm_f32f32", 110)] == "coarse"
    assert layer[("gatherTopK", 510)] == "coarse"
    assert layer[("sm90_xmma_gemm_f32f32", 610)] == "tables"
    assert layer[("gatherTopK", 700)] == "scan_topk"
    assert layer[("adc_scan_slots_kernel_block", 660)] == "scan_topk"
    assert layer[("elementwise", 900)] == "other"
    assert t.n_steps == 1
    assert t.layer_us("coarse") == 500
    assert t.layer_us("tables") == 50
    assert t.layer_us("scan_topk") == 120
    assert len(t.step_ops()) == 5


def test_busy_window_and_breakdown():
    t = Trace(toy_events())
    assert t.window() == (0, 780)
    # 110..780 with the 40 us kernel inside 610..700
    assert t.busy_us() == 400 + 100 + 50 + 40 + 80 - 0
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["sm90_xmma_gemm_f32f32", 450e-6]
    assert bd["idle_gaps"][0][0] == "before coarse"
    assert abs(bd["idle_gaps"][0][1] - 110e-6) < 1e-12


def test_exact_assignment_outranks_coarse():
    ev = [{"ph": "X", "cat": "user_annotation", "name": STEP, "ts": 0,
           "dur": 50, "tid": 1},
          frame("models/ivfadc.py", "add_batch", 0, 50),
          frame("models/ivfadc.py", "_assign_exact_t", 1, 20),
          frame("ops/distances.py", "streaming_topk_l2", 2, 18),
          frame("models/ivfadc.py", "encode_batch", 25, 10),
          launch(1, 3), kernel("gemm", 1, 100, 10),
          launch(2, 26), kernel("bmm", 2, 120, 10),
          launch(3, 40), {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
                          "ts": 140, "dur": 5, "tid": 7,
                          "args": {"correlation": 3}}]
    t = Trace(ev)
    assert [op[4] for op in t.ops] == ["assign", "encode", "store"]


def test_gap_named_by_host_op_without_frames():
    """In the device stretch (no Python stack) an idle gap is named by the
    host op that launched the next operation."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": STEP, "ts": 0,
           "dur": 100, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::topk", "ts": 4,
           "dur": 3, "tid": 1, "args": {"External id": 8}},
          launch(1, 5), {"ph": "X", "cat": "kernel", "name": "gatherTopK",
                         "ts": 300, "dur": 50, "tid": 7,
                         "args": {"correlation": 1, "External id": 8}}]
    t = Trace(ev, layers={})
    assert t.ops[0][4] == "other" and t.ops[0][5] == "aten::topk"
    assert t.breakdown()["idle_gaps"][0][0] == "before aten::topk"


def test_tracer_stretches_in_order():
    import pytest

    from annbench.trace import Tracer
    tr = Tracer({"trace_first": 1, "trace_steps": 2, "idle_first": 4,
                 "idle_steps": 3}, False)
    assert [(s.lead, s.last, s.stack) for s in tr.stretches.values()] == [
        (0, 2, True), (3, 6, False)]
    assert tr.covers(2) and not tr.covers(3) and tr.covers(6)
    with pytest.raises(ValueError):
        Tracer({"trace_first": 1, "trace_steps": 2, "idle_first": 3,
                "idle_steps": 3}, False)
