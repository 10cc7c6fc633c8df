"""The scan-lab wrappers of the PyTorch port (ivfhnsw_tpu_torch.ops.cuda.
scan_lab): dispatch, argument checks and the plain versions on the CPU, the
variant table against csrc/scan_lab.cu, and every compiled variant against
its plain version on a card.

This file imports no jax, so it also runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scan_lab_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false.
Tolerance: none. The full-function variants sum in the production kernel's
order and are held to torch.equal with their plain versions and with
adc_scan_slots / adc_scan_slots_min; compute-only and copy-only sum in
their plain versions' order and are held to torch.equal too.
"""

import os
import re

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl

NAMES = sorted(sl.VARIANTS)
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ivfhnsw_tpu_torch", "csrc", "scan_lab.cu")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _args(device="cpu", M=8, gran=256):
    """3 queries x 7 slots over a 5001-row store (neither N nor N*M is a
    multiple of 16 at M=8): empty, one code, a partial and a full slot, a
    partial and a full slot ending at the store's last row, and a slot at
    an odd start row."""
    rng = np.random.RandomState(1)
    B, N = 3, 5001
    lens = [0, 1, gran // 2 + 3, gran, 77, gran, gran - 5]
    starts = [0, 17, 100, 5, N - 77, N - gran, 1001]
    lut = torch.from_numpy(rng.randn(B, M, 256).astype(np.float32))
    ntab = torch.from_numpy(rng.rand(256).astype(np.float32) * 10)
    codes = torch.from_numpy(rng.randint(0, 256, (N, M)).astype(np.uint8))
    ncodes = torch.from_numpy(rng.randint(0, 256, N).astype(np.uint8))
    start = torch.tensor([starts] * B, dtype=torch.int64)
    start[1:, 2] += 40                       # differ across queries
    length = torch.tensor([lens] * B, dtype=torch.int32)
    bias = torch.from_numpy(rng.randn(B, len(lens)).astype(np.float32))
    return [x.to(device) for x in (lut, ntab, codes, ncodes, start, length,
                                   bias)]


def _call(v, args, **kw):
    wrapper, _ = sl.FUNCTIONS[v.kind]
    return wrapper(*args, v, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_dispatch_runs_plain_and_counts_no_launch(name):
    v = sl.VARIANTS[name]
    args = _args(gran=v.gran)
    wrapper, plain = sl.FUNCTIONS[v.kind]
    before = dict(sl.LAUNCHES)
    out = wrapper(*args, v)
    assert sl.LAUNCHES == before
    S = args[4].shape[1]
    assert out.shape == ((3, S) if v.epilogue == "min" else (3, S * v.gran))
    assert torch.equal(out, plain(*args, v))
    if v.full:
        prod = (tk.adc_scan_slots_min if v.epilogue == "min"
                else tk.adc_scan_slots)(*args, v.gran)
        assert torch.equal(out, prod)
    lanes = out if v.epilogue == "min" else out.view(3, S, v.gran)[..., 0]
    assert torch.isinf(lanes[:, 0]).all() and torch.isfinite(lanes[:, 1:]).all()


def test_compute_only_plain_by_hand():
    v = sl.VARIANTS["comp256_wide"]
    lut, ntab, codes, ncodes, start, length, bias = _args()
    out = sl.scan_compute_only(lut, ntab, codes, ncodes, start, length, bias,
                               v, tile_row=300).view(3, 7, 256)
    b, s, l = 1, 2, 100
    r = 300 + l                                # the staged row, not start+l
    expect = float(ntab[int(ncodes[r])]) + sum(
        float(lut[b, m, int(codes[r, m])]) for m in range(8))
    assert float(out[b, s, l]) == pytest.approx(expect, rel=1e-6)
    assert torch.isinf(out[b, s, int(length[b, s]):]).all()
    # no bias: the same lanes of two slots agree
    assert torch.equal(out[0, 3, :100], out[0, 2, :100])


def test_copy_only_plain_by_hand():
    v = sl.VARIANTS["copy1024_min"]
    lut, ntab, codes, ncodes, start, length, bias = _args(gran=1024)
    wide = sl.scan_copy_only_plain(lut, ntab, codes, ncodes, start, length,
                                   bias, sl.VARIANTS["copy1024_wide"])
    b, s, l = 2, 6, 500
    r = int(start[b, s]) + l
    assert float(wide[b, s * 1024 + l]) == int(ncodes[r]) + int(
        codes[r].long().sum())
    mins = sl.scan_copy_only(lut, ntab, codes, ncodes, start, length, bias, v)
    assert torch.equal(mins, wide.view(3, 7, 1024).amin(-1))


def test_variant_table_matches_the_cuda_source():
    """Every VARIANTS entry is one LAB_PIPE / LAB_RUNS instantiation of
    csrc/scan_lab.cu with the same parameters, and nothing else is."""
    with open(SOURCE) as f:
        src = f.read()
    found = {}
    for m in re.finditer(r"^LAB_PIPE\((\w+), (\d+), (\d+), (\d+), (\d+), "
                         r"(true|false), (true|false), (\w+), (\w+)\)", src,
                         re.M):
        name, gran, c, d, s, bw, nb, mode, epi = m.groups()
        kind = {"FULL": "pipelined", "COMPUTE_ONLY": "compute_only",
                "COPY_ONLY": "copy_only"}[mode]
        found[name] = (kind, int(gran), int(c), int(d), int(s), bw == "true",
                       nb == "true", {"WIDE": "wide", "MIN": "min"}[epi])
    for m in re.finditer(r"^LAB_RUNS\((\w+), (\d+)\)", src, re.M):
        found[m.group(1)] = ("runs", 1024, 1, int(m.group(2)), 1, False,
                             False, "wide")
    table = {n: (v.kind, v.gran, v.copies, v.depth, v.slots_per_step,
                 v.batched_wait, v.branchless, v.epilogue)
             for n, v in sl.VARIANTS.items()}
    assert found == table
    assert len(table) <= 24


@pytest.mark.parametrize("bad", ["kind", "foreign", "dtype", "shape",
                                 "device", "tile_row"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    args = _args()
    v = sl.VARIANTS["pipe256_c1_d8_s2"]
    fn = sl.scan_pipelined
    kw = {}
    if bad == "kind":
        fn = sl.scan_copy_only
    elif bad == "foreign":
        v = sl.Variant("pipe256_c1_d8_s2", "pipelined", 256, "x", depth=4)
    elif bad == "dtype":
        args[5] = args[5].long()                      # length
    elif bad == "shape":
        args[0] = args[0][:, :, :128].contiguous()    # lut
    elif bad == "device":
        args[6] = args[6].to("meta")                  # bias
    else:
        fn, v = sl.scan_compute_only, sl.VARIANTS["comp256_wide"]
        kw = {"tile_row": 5001 - 100}
    with pytest.raises((TypeError, ValueError)):
        fn(*args, v, **kw)


def test_reset_launches():
    sl.LAUNCHES["runs1024_d2"] = 3
    sl.LAUNCHES["copy256_min"] = 1
    sl.reset_launches()
    assert set(sl.LAUNCHES) == set(sl.VARIANTS)
    assert not any(sl.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_on_card(name, M):
    """Every instantiation at M=16 (16-byte rows) and M=8 (8-byte rows, a
    store whose byte counts end off a 16-byte boundary): torch.equal to its
    plain version and, for a full-function variant, to the production
    kernel; compute-only at an odd tile row."""
    _need_card()
    v = sl.VARIANTS[name]
    args = _args("cuda", M=M, gran=v.gran)
    kw = {"tile_row": 333} if v.kind == "compute_only" else {}
    wrapper, plain = sl.FUNCTIONS[v.kind]
    before = dict(sl.LAUNCHES)
    out = wrapper(*args, v, **kw)
    torch.cuda.synchronize()
    assert sl.LAUNCHES == {**before, name: before[name] + 1}
    assert torch.equal(out, plain(*args, v, *kw.values()))
    if v.full:
        prod = (tk.adc_scan_slots_min if v.epilogue == "min"
                else tk.adc_scan_slots)(*args, v.gran)
        assert torch.equal(out, prod)


@pytest.mark.cuda
def test_occupancy_and_smem_floor_on_card():
    """The occupancy query reports the dynamic shared memory of the launch;
    8 LUT copies need more of it than 1, and a floor at the 8-copy size
    brings the 1-copy kernel to the same blocks per SM (and still equal
    output)."""
    _need_card()
    c1, c8 = sl.VARIANTS["pipe256_c1_d8_s2"], sl.VARIANTS["pipe256_c8_d8_s2"]
    b1, s1 = sl.occupancy(c1, 16)
    b8, s8 = sl.occupancy(c8, 16)
    assert s8 > s1 and 1 <= b8 <= b1
    assert sl.occupancy(c1, 16, s8) == (b8, s8)
    args = _args("cuda", M=16)
    assert torch.equal(sl.scan_pipelined(*args, c1, smem_floor=s8),
                       sl.scan_pipelined(*args, c1))


@pytest.mark.cuda
def test_kernels_reject_cpu_mixed_with_card():
    _need_card()
    args = _args("cuda")
    args[3] = args[3].cpu()
    with pytest.raises(ValueError):
        sl.scan_copy_only(*args, sl.VARIANTS["copy256_wide"])
