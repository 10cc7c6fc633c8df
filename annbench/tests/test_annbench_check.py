"""The check that decides ``correct``, on the CPU at toy size: the port
passes against the reference for both configurations and the add path;
the control (the reference in the program's place at TF32) fails and the
same reference at float32 passes; and a run whose timed path is broken
underneath comes out not correct, once for each fault the cell can have."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from annbench import harness
from annbench.control import control_numbers
from annbench.tests.toy import bench
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex

CELLS = ["sift1b-ivfadc16.batch-10k", "deep1b-grouping-opq16.batch-10k",
         "deep1b-grouping-opq16.noprune-10k", "sift1b-ivfadc16.add-1m"]
SEARCH = CELLS[:3]
ADD = CELLS[3]


def run(toy, cell, seed=11):
    return harness.run_cell(cell, seed, 0.3, False, "cpu", bench(),
                            time.perf_counter(), log=lambda s: None, base=toy)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(toy, cell):
    out = run(toy, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_f32_passes(toy, cell):
    assert not control_numbers(cell, 2 ** 32 + 3, "tf32", "cpu", toy)[
        "correct"]
    assert control_numbers(cell, 2 ** 32 + 3, "f32", "cpu", toy)["correct"]


def _half_batch(orig):
    def search_device(self, q, params=None, batch=8192):
        d, l = orig(self, q[: q.shape[0] // 2], params, batch)
        return torch.cat([d, d]), torch.cat([l, l])
    return search_device


def _altered(orig):
    def search_device(self, q, params=None, batch=8192):
        d, l = orig(self, q, params, batch)
        l = l.clone()
        l[:, 0] = torch.where(l[:, 0] >= 0, (l[:, 0] + 1) % 16384, l[:, 0])
        return d, l
    return search_device


def _stale(orig):
    last = {}

    def search_device(self, q, params=None, batch=8192):
        out = last.get("out") or orig(self, q, params, batch)
        last["out"] = out
        return out
    return search_device


@pytest.mark.parametrize("cell", SEARCH)
@pytest.mark.parametrize("fault", [_half_batch, _altered, _stale])
def test_search_faults_fail(toy, cell, fault, monkeypatch):
    monkeypatch.setattr(IVFADCIndex, "search_device",
                        fault(IVFADCIndex.search_device))
    assert not run(toy, cell)["correct"]


def _add_unchanged(orig):
    def add_batch_device(self, x, xids=None, *a, **k):
        if int(np.asarray(xids)[0]) < 16384 + 2048:   # base and warm-up
            return orig(self, x, xids, *a, **k)
        return None
    return add_batch_device


def _add_half(orig):
    def add_batch_device(self, x, xids=None, *a, **k):
        n = x.shape[0] // 2
        return orig(self, x[:n], np.asarray(xids)[:n], *a, **k)
    return add_batch_device


def _add_altered(orig):
    def add_batch(self, x, xids=None, precomputed_idx=None):
        enc = self._encode_batch

        def flipped(xx, keys):
            c, n = enc(xx, keys)
            c = c.clone()
            c[:, 0] ^= 1
            return c, n
        self._encode_batch = flipped
        try:
            return orig(self, x, xids, precomputed_idx)
        finally:
            del self._encode_batch
    return add_batch


@pytest.mark.parametrize("fault", [_add_unchanged, _add_half, _add_altered])
def test_add_faults_fail(toy, fault, monkeypatch):
    name = "add_batch" if fault is _add_altered else "add_batch_device"
    orig = getattr(IVFADCIndex, name)
    run(toy, ADD)                                   # the toy is sound first
    monkeypatch.setattr(IVFADCIndex, name, fault(orig))
    assert not run(toy, ADD)["correct"]


def test_pruned_answers_fail_the_unpruned_judge(toy, monkeypatch):
    """The cell's operating point reaches the judge: answers searched with
    pruning on, in a cell whose traffic turns pruning off, are not
    correct."""
    from annbench.systems import grouping
    cell = "deep1b-grouping-opq16.noprune-10k"
    # On the toy, pruning moves answers only where the budget binds inside
    # the nearest lists (pruning's mean then spans them alone).
    path = os.path.join(toy, "traffic", "noprune-10k.json")
    with open(path) as f:
        tr = json.load(f)
    tr["search"]["max_codes"] = 200
    with open(path, "w") as f:
        json.dump(tr, f)
    assert not harness.load_cell(cell, toy)["config"]["do_pruning"]
    assert run(toy, cell)["correct"]
    orig = grouping.search_params
    monkeypatch.setattr(grouping, "search_params", lambda cfg: (
        dataclasses.replace(orig(cfg), do_pruning=True)))
    assert not run(toy, cell)["correct"]
