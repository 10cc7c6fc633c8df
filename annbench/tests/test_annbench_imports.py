"""Nothing a run loads has the top-level name of JAX or of the JAX package
(names compared whole: the port's ``ivfhnsw_tpu_torch`` begins with the JAX
package's name), and the reference loads nothing of the port."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RUN = """
import json, sys, tempfile, time
sys.path.insert(0, {root!r})
import torch
from annbench import harness
from annbench.tests.toy import bench, toy_base
with tempfile.TemporaryDirectory() as d:
    harness.run_cell("sift1b-ivfadc16.batch-10k", 3, 0.2, False, "cpu",
                     bench(), time.perf_counter(), log=lambda s: None,
                     base=toy_base(d))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import annbench.reference.judge, annbench.control, annbench.gen.deployment
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = top_level(RUN)
    assert "ivfhnsw_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ivfhnsw_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = top_level(REF)
    assert not names & {"jax", "jaxlib", "flax", "ivfhnsw_tpu",
                        "ivfhnsw_tpu_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    from annbench import harness
    monkeypatch.setitem(sys.modules, "ivfhnsw_tpu_torch_x", sys)
    assert "ivfhnsw_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
