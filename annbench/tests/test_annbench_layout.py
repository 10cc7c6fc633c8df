"""The benchmark is driven by data: BENCHMARK.json agrees with the files it
names, and a cell, configuration, traffic mix or per-layer metric is added
by adding files."""

import ast
import json
import os
import shutil
import time

import torch

from annbench import harness
from annbench.gen.deployment import Deployment
from annbench.tests.toy import bench
from annbench.trace import load_layers

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_LAYERS = {"index entry", "device", "store"}


def test_benchmark_json_matches_files():
    b = bench()
    for w in b["workloads"]:
        spec = harness.load_cell(w["name"])
        assert spec["cell"]["config"] == w["config"]
        assert spec["cell"]["traffic"] == w["traffic"]
        assert spec["chips"] == w["chips"] == 1
        assert spec["cell"]["why"] == w["why"]
        assert spec["config"]["name"] == w["config"]
    for c in b["configs"]:
        with open(os.path.join(os.path.dirname(BENCH), c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]
        assert not set(c["reduced"]) & set(cfg.get("raised", {}))
        for key, v in cfg["published"].items():
            assert (key in c["reduced"] or key in cfg.get("raised", {})
                    or cfg[key] == v), key
    layers = {v["layer"] for v in load_layers().values()} | HOST_LAYERS
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert m["layer"] in layers
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_new_cell_runs_from_files_alone(toy):
    """A copy with one more workload file (an existing configuration under
    an existing mix, by another name) runs with no edit."""
    src = os.path.join(toy, "workloads", "sift1b-ivfadc16.batch-10k.json")
    shutil.copy(src, os.path.join(toy, "workloads", "extra.cell.json"))
    b = bench()
    like = "sift1b-ivfadc16.batch-10k"
    b["end_to_end"] = [dict(e, workloads=e["workloads"] + ["extra.cell"])
                       if like in e.get("workloads", []) else e
                       for e in b["end_to_end"]]
    out = harness.run_cell("extra.cell", 7, 0.3, False, "cpu", b,
                           time.perf_counter(), log=lambda s: None, base=toy)
    assert out["correct"]
    assert set(out["metrics"]) == {"qps", "setup_s"}


def test_generators_deterministic_in_seed(toy):
    spec = harness.load_cell("deep1b-grouping-opq16.batch-10k", toy)
    a = Deployment(spec["config"], 2 ** 33 + 5, "cpu")
    b = Deployment(spec["config"], 2 ** 33 + 5, "cpu")
    c = Deployment(spec["config"], 2 ** 33 + 6, "cpu")
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.chunk(1)[0], b.chunk(1)[0])
    assert torch.equal(a.queries(64), b.queries(64))
    assert torch.equal(a.rotation, b.rotation)
    assert torch.equal(a.quantizers()[0], b.quantizers()[0])
    assert not torch.equal(a.chunk(1)[0], c.chunk(1)[0])
    spec = harness.load_cell("sift1b-ivfadc16.add-1m", toy)
    a = Deployment(spec["config"], 9, "cpu")
    b = Deployment(spec["config"], 9, "cpu")
    assert torch.equal(a.segment(3, 100), b.segment(3, 100))


def test_layer_frames_exist_in_the_port():
    """Every (file, function) that a layer file names is defined in the
    port: after a rename there, its launches would go to "other" unseen."""
    root = os.path.dirname(BENCH)
    for stem, spec in load_layers().items():
        for file, func in spec["frames"]:
            assert file.startswith("ivfhnsw_tpu_torch/"), (stem, file)
            with open(os.path.join(root, file)) as f:
                tree = ast.parse(f.read())
            assert func in {n.name for n in ast.walk(tree) if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))}, (stem, file,
                                                                func)
