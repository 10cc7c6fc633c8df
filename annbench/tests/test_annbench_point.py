"""A cell's search operating point comes from its traffic, and a
configuration's reference is found by name: both are added by files
alone. The refactor that brought them left every existing cell's check
numbers as they were."""

import json
import os
import sys
import time
import types

import pytest
import torch

from annbench import harness, reference
from annbench.control import control_numbers
from annbench.loops import add_closed, search_batch
from annbench.tests.toy import bench

HERE = os.path.dirname(os.path.abspath(__file__))
LIKE = "sift1b-ivfadc16.batch-10k"


def _add_cell(toy, name, config, traffic_name, traffic):
    with open(os.path.join(toy, "traffic", traffic_name + ".json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(toy, "workloads", name + ".json"), "w") as f:
        json.dump({"config": config, "traffic": traffic_name, "chips": 1,
                   "why": "a toy cell"}, f)
    b = bench()
    b["end_to_end"] = [dict(e, workloads=e["workloads"] + [name])
                       if LIKE in e.get("workloads", []) else e
                       for e in b["end_to_end"]]
    return b


def _traffic(toy, name="batch-10k"):
    with open(os.path.join(toy, "traffic", name + ".json")) as f:
        return json.load(f)


def test_traffic_sets_the_operating_point(toy):
    """A copy with one more traffic file that sets nprobe and max_codes
    runs from files alone, at that point: the system, the log line and the
    judge see it, and the configuration file is unchanged."""
    tr = dict(_traffic(toy), search={"nprobe": 3, "max_codes": 300})
    b = _add_cell(toy, "extra.np3", "sift1b-ivfadc16", "np3", tr)
    spec = harness.load_cell("extra.np3", toy)
    assert (spec["config"]["nprobe"], spec["config"]["max_codes"]) == (3, 300)
    with open(os.path.join(toy, "configs", "sift1b-ivfadc16.json")) as f:
        assert json.load(f)["nprobe"] == 8
    logged = []
    out = harness.run_cell("extra.np3", 7, 0.3, False, "cpu", b,
                           time.perf_counter(), log=logged.append, base=toy)
    assert out["correct"], out["checks"]
    assert "operating point: nprobe 3, max_codes 300, do_pruning False" \
        in logged


def test_answers_at_another_point_fail(toy, monkeypatch):
    """Answers searched at the configuration's point (nprobe 8) are not
    correct in a cell whose traffic sets a narrower one (nprobe 1)."""
    from annbench.systems import grouping
    tr = dict(_traffic(toy), search={"nprobe": 1})
    b = _add_cell(toy, "extra.np1", "deep1b-grouping-opq16", "np1", tr)
    orig = grouping.search_params
    monkeypatch.setattr(grouping, "search_params",
                        lambda cfg: orig(dict(cfg, nprobe=8)))
    out = harness.run_cell("extra.np1", 7, 0.3, False, "cpu", b,
                           time.perf_counter(), log=lambda s: None, base=toy)
    assert not out["correct"]


@pytest.mark.parametrize("point", [{"nprobe": 4, "k": 5}, {"chunk": 8},
                                   [4]])
def test_other_search_keys_raise(toy, point):
    tr = dict(_traffic(toy), search=point)
    _add_cell(toy, "extra.bad", "sift1b-ivfadc16", "bad", tr)
    with pytest.raises(ValueError, match="may set only"):
        harness.load_cell("extra.bad", toy)


TOYREF = '''
from annbench.reference import ivfadc

CALLS = []


def judge_search(cfg, *args):
    CALLS.append(cfg["name"])
    nums, ref = ivfadc.judge_search(cfg, *args)
    return dict(nums, toy_gap=0.5), ref


control_search = ivfadc.control_search
'''


def test_reference_module_found_by_name(toy, tmp_path, monkeypatch):
    """A configuration that names a reference module added as a file is
    judged by it, its own number beside its limit."""
    (tmp_path / "toyref.py").write_text(TOYREF)
    monkeypatch.setattr(reference, "__path__",
                        list(reference.__path__) + [str(tmp_path)])
    path = os.path.join(toy, "configs", "sift1b-ivfadc16.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["reference"] = "toyref"
    cfg["limits"]["search"]["toy_gap"] = 1.0
    with open(path, "w") as f:
        json.dump(cfg, f)
    try:
        out = harness.run_cell(LIKE, 7, 0.3, False, "cpu", bench(),
                               time.perf_counter(), log=lambda s: None,
                               base=toy)
        toyref = sys.modules["annbench.reference.toyref"]
        assert toyref.CALLS == ["sift1b-ivfadc16"]
        assert out["checks"]["toy_gap"] == {"value": 0.5, "limit": 1.0}
        assert out["correct"]
        assert not control_numbers(LIKE, 2 ** 32 + 3, "tf32", "cpu",
                                   toy)["correct"]
    finally:
        sys.modules.pop("annbench.reference.toyref", None)


class _Clock:
    """A clock that moves 0.1 s a reading, so that a window holds a fixed
    number of calls or segments whatever the machine's speed."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.1
        return self.t


def test_existing_checks_as_before(toy, monkeypatch):
    """Each existing cell's check numbers, on the toy at fixed seeds, one
    thread and a window of fixed steps, are bit-equal to those the
    benchmark's code gave before cells could set their operating point
    and configurations their reference (``checks_before.json``)."""
    with open(os.path.join(HERE, "checks_before.json")) as f:
        before = json.load(f)
    if before["torch"] != torch.__version__:
        pytest.skip(f"recorded under torch {before['torch']}, "
                    f"this is {torch.__version__}")
    for mod in (add_closed, search_batch):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=_Clock().perf_counter))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for key, want in before["checks"].items():
            cell, what, arg = key.split("/")
            if what == "run":
                got = harness.run_cell(cell, int(arg), 1.0, False, "cpu",
                                       bench(), time.perf_counter(),
                                       log=lambda s: None, base=toy)
            else:
                got = control_numbers(cell, 2 ** 32 + 3, arg, "cpu", toy)
            assert {k: v["value"] for k, v in got["checks"].items()} == \
                want, key
    finally:
        torch.set_num_threads(threads)
