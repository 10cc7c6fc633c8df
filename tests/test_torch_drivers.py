"""The PyTorch port's driver commands (ivfadc_eval, grouping_eval, enn):
``-device`` defaults to cuda, a CUDA device on a machine without a card is
an error and never a fall-back to the CPU, and ``-device cpu`` runs each
driver's rehearsal at a tiny size; on a card, importing drivers.common
alone leaves TF32 off. Imports no jax.
"""

import importlib
import os
import subprocess
import sys

import pytest
import torch

from ivfhnsw_tpu_torch.drivers import common as C

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["-synthetic", "0", "-d", "32", "-nc", "64", "-code_size", "8",
        "-nb", "6000", "-nt", "3000", "-nq", "100", "-nprobe", "8",
        "-max_codes", "1000", "-k", "10"]
DRIVERS = {
    "ivfadc_eval": TINY,
    "grouping_eval": TINY + ["-nsubc", "8", "-do_pruning", "on",
                             "-do_opq", "on"],
    "enn": TINY,
}


def _driver(name):
    return importlib.import_module(f"ivfhnsw_tpu_torch.drivers.{name}")


def test_parsed_device_defaults_to_cuda():
    _, extras = C.parse_driver_args(("synthetic", "device"), ["-synthetic",
                                                              "0"])
    assert extras == {"synthetic": "0", "device": "cuda"}
    _, extras = C.parse_driver_args(("synthetic", "device"),
                                    ["-synthetic", "0", "-device", "cpu"])
    assert extras["device"] == "cpu"


@pytest.mark.parametrize("name", DRIVERS)
def test_default_device_without_a_card_is_an_error(name, monkeypatch):
    """With no -device and no card the driver stops before it builds
    anything: the default is cuda, with no fall-back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _driver(name).main(DRIVERS[name])


@pytest.mark.parametrize("name", DRIVERS)
def test_cpu_rehearsal_runs_and_prints_recall(name, capsys):
    _driver(name).main(DRIVERS[name] + ["-device", "cpu"])
    out = capsys.readouterr().out
    r1 = [ln for ln in out.splitlines() if ln.startswith("Recall@1:")]
    assert r1 and 0.0 < float(r1[0].split()[1]) <= 1.0, out
    assert "Time per query" in out


@pytest.mark.cuda
def test_driver_module_alone_switches_tf32_off():
    """exact_nn's ground truth needs full-precision matmuls; importing
    drivers.common alone, in a fresh interpreter, must leave TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code = ("import torch; torch.backends.cuda.matmul.allow_tf32 = True; "
            "torch.backends.cudnn.allow_tf32 = True; "
            "import ivfhnsw_tpu_torch.drivers.common; "
            "assert torch.backends.cuda.matmul.allow_tf32 is False; "
            "assert torch.backends.cudnn.allow_tf32 is False")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_dryrun_runs_on_the_cpu(capsys):
    """tools/dryrun.py (the counterpart of __graft_entry__.py): the
    multi-shard dry run over 8 CPU shards and the single-index step."""
    from ivfhnsw_tpu_torch.tools import dryrun
    dryrun.main(["-n", "8", "-device", "cpu"])
    out = capsys.readouterr().out
    assert "sharded search + build + grouping steps OK over 8 shards" in out
    assert "entry(): (16, 10) (16, 10)" in out


def test_dryrun_default_device_without_a_card_is_an_error(monkeypatch):
    from ivfhnsw_tpu_torch.tools import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["-n", "2"])
