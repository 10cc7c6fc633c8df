"""The min-scan kernel (K3/K4) of the PyTorch port and its design steps:
the step table against csrc/scan_lab.cu and the production setting in
csrc/adc_scan.cu, the steps' plain versions and wrapper on the CPU,
tools/min_probe.py's SASS reader and its run on the CPU, and, on a card,
every step and the production kernel against their plain versions.

This file imports no jax, so it also runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_min_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false.
Tolerance: none. Every "full" step and the production kernel sum each lane
as the plain version does (bias, norm, m = 0..M-1 in f32) and keep the
exact minimum, so they are held to torch.equal with
adc_scan_slots_min_plain and with the wide kernel's per-slot minima; the
"compute" and "loads" steps to torch.equal with their own plain versions.
"""

import os
import re

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.tools import min_probe as mp

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ivfhnsw_tpu_torch", "csrc")
STEPS = sorted(sl.MIN_STEPS)
FULL = [n for n in STEPS if sl.MIN_STEPS[n].mode == "full"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _args(device="cpu", M=16, gran=256, B=5, misalign=False):
    """B queries x 12 slots over a 5003-row store: empty slots (alone and
    in runs), one code, ragged partial slots, full slots, slots whose len
    exceeds gran (clipped), a slot ending at the store's last row, and two
    slots whose rows repeat one code row (tied minima, inside a slot and
    across the two); query 0 is all empty when B > 1. ``misalign`` puts
    the codes one byte into their buffer."""
    rng = np.random.RandomState(11)
    N = 5003
    lens = [0, 1, gran // 2 + 3, 0, 0, gran, gran + 77, 77, gran - 5, 40,
            33, 3 * gran]
    starts = [0, 17, 101, 0, 0, 5, 300, N - 77, 1001, 4000, 4000, 0]
    lut = torch.from_numpy(rng.randn(B, M, 256).astype(np.float32) * 3)
    ntab = torch.from_numpy(rng.rand(256).astype(np.float32) * 10)
    codes = rng.randint(0, 256, (N, M)).astype(np.uint8)
    ncodes = rng.randint(0, 256, N).astype(np.uint8)
    codes[4000:4040] = codes[4000]            # one row 40 times: ties
    ncodes[4000:4040] = ncodes[4000]
    codes, ncodes = torch.from_numpy(codes), torch.from_numpy(ncodes)
    start = torch.tensor([starts] * B, dtype=torch.int64)
    start[B // 2:, 2] += 40
    start[:, 11] = torch.arange(B) * 7        # differs across queries
    length = torch.tensor([lens] * B, dtype=torch.int32)
    length[:, 11] = torch.clamp(length[:, 11], max=N - int(start[:, 11].max()))
    if B > 1:
        length[0] = 0
    bias = torch.from_numpy(rng.randn(B, len(lens)).astype(np.float32))
    bias[:, 10] = bias[:, 9]                  # the same tie in two slots
    out = [x.to(device) for x in (lut, ntab, codes, ncodes, start, length,
                                  bias)]
    if misalign:
        buf = torch.zeros(out[2].numel() + 1, dtype=torch.uint8,
                          device=device)
        buf[1:] = out[2].reshape(-1)
        out[2] = buf[1:].view(out[2].shape)
    return out


# ---- the step table ---------------------------------------------------------

_MSTEP = re.compile(r"^MSTEP\((\w+), (\d+), (\w+), (true|false), (\d+), "
                    r"(\w+), (true|false), (\w+)\)\s*// (\d+)", re.M)
_MODES = {"FULL": "full", "COMPUTE": "compute", "LOADS": "loads"}


def test_step_table_matches_the_cuda_source():
    """Every MIN_STEPS entry but the first port is one MSTEP line of
    csrc/scan_lab.cu with the same id and switches, and ivf_lab_mstep's
    switch launches it under that id."""
    with open(os.path.join(CSRC, "scan_lab.cu")) as f:
        src = f.read()
    found = {}
    for m in _MSTEP.finditer(src):
        name, minb, addr, off32, cps, stage, pf, mode, sid = m.groups()
        found[name] = sl.MinStep(name, int(sid), addr.lower(),
                                 off32 == "true", int(cps), stage.lower(),
                                 pf == "true", _MODES[mode], int(minb))
        assert re.search(rf"case {sid}: fn = reinterpret_cast<const void\*>"
                         rf"\(mstep_{name}\)", src)
    assert "case 0: fn = reinterpret_cast<const void*>(direct_min_kernel)" \
        in src
    table = {n: s for n, s in sl.MIN_STEPS.items() if s.step != 0}
    assert found == table
    assert sorted(s.step for s in sl.MIN_STEPS.values()) == list(
        range(len(sl.MIN_STEPS)))
    assert sl.MIN_STEPS["first_port"].kernel == "direct_min_kernel"
    assert sl.MIN_STEPS["two"].kernel == "mstep_two"


def test_production_is_the_named_step():
    """csrc/adc_scan.cu's min kernel instantiates min_scan.cuh's body at
    the switches and launch bounds of scan_lab.PRODUCTION_STEP."""
    with open(os.path.join(CSRC, "adc_scan.cu")) as f:
        src = f.read()
    m = re.search(r"adc_scan_slots_min_kernel\(min_scan::Params p\) \{\s*"
                  r"min_scan::body<min_scan::ADDR_(\w+), (true|false), (\d+), "
                  r"min_scan::STAGE_(\w+), (true|false),\s*"
                  r"min_scan::(\w+)>\(p, 0u\);", src)
    assert m
    addr, off32, cps, stage, pf, mode = m.groups()
    st = sl.MIN_STEPS[sl.PRODUCTION_STEP]
    assert (st.addr, st.off32, st.cps, st.stage, st.pf, st.mode) == (
        addr.lower(), off32 == "true", int(cps), stage.lower(), pf == "true",
        _MODES[mode])
    assert re.search(rf"__launch_bounds__\(min_scan::THREADS, "
                     rf"{st.min_blocks}\)\s*adc_scan_slots_min_kernel", src)


# ---- plain versions and the wrapper on the CPU ----------------------------

def test_card_args_cover_what_the_card_tests_need():
    """The card tests' inputs through the plain versions: an all-empty
    query, runs of empty slots, slots clipped at gran, tied minima."""
    a = _args(gran=256, B=5)
    mins = tk.adc_scan_slots_min(*a, 256)
    wide = tk.adc_scan_slots(*a, 256).view(5, 12, 256)
    assert torch.isinf(mins[0]).all()
    assert torch.isinf(mins[1:, [0, 3, 4]]).all()
    assert torch.isfinite(mins[1:, [1, 2, 5, 6, 7, 8, 9, 10, 11]]).all()
    assert torch.equal(mins, wide.amin(-1))
    assert torch.isfinite(wide[1:, 6]).all()          # len 333 clipped
    assert torch.equal(mins[1:, 9], mins[1:, 10])     # tied across slots
    assert (wide[1:, 9, :40] == mins[1:, 9, None]).all()  # and inside one


@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", STEPS)
def test_cpu_dispatch_runs_plain_and_counts_no_launch(name, gran):
    st = sl.MIN_STEPS[name]
    a = _args(gran=gran)
    before = dict(sl.MIN_LAUNCHES)
    out = sl.scan_min_step(*a, gran, st)
    assert sl.MIN_LAUNCHES == before
    assert out.shape == (5, 12)
    assert torch.equal(out, sl.min_step_plain(*a, gran, st))
    if st.mode == "full":
        assert torch.equal(out, tk.adc_scan_slots_min_plain(*a, gran))
    assert torch.isinf(out[0]).all() and torch.isinf(out[1:, 0]).all()


def test_compute_plain_is_the_first_lanes_minimum():
    a = _args()
    out = sl.min_step_plain(*a, 256, sl.MIN_STEPS["comp"])
    wide = tk.adc_scan_slots_plain(*a, 256).view(5, 12, 256)
    assert torch.equal(out, wide[:, :, :32].amin(-1))
    assert (out[1:, 7] >= wide[1:, 7].amin(-1)).all()   # 32 of 77 codes


def test_loads_plain_by_hand():
    a = _args(gran=1024)
    lut, ntab, codes, ncodes, start, length, bias = a
    out = sl.min_step_plain(*a, 1024, sl.MIN_STEPS["loads_new"])
    b, s = 3, 8
    vals = []
    for l in range(int(length[b, s])):
        r = int(start[b, s]) + l
        w = [int.from_bytes(bytes(codes[r, 4 * q:4 * q + 4].tolist()),
                            "little") for q in range(4)]
        vals.append((w[0] ^ w[1] ^ w[2] ^ w[3] ^ int(ncodes[r])) & 0xFFFFFF)
    assert float(out[b, s]) == min(vals)
    assert torch.isinf(out[0]).all()


@pytest.mark.parametrize("bad", ["foreign", "dtype", "shape", "device",
                                 "gran", "m8_compute", "m8_loads"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    a = _args()
    st, gran = sl.MIN_STEPS["two"], 256
    if bad == "foreign":
        st = sl.MinStep("two", 5, addr="prmt", off32=True, cps=4)
    elif bad == "dtype":
        a[4] = a[4].int()                             # start
    elif bad == "shape":
        a[0] = a[0][:, :8].contiguous()               # lut
    elif bad == "device":
        a[6] = a[6].to("meta")                        # bias
    elif bad == "gran":
        gran = 0
    else:
        a = _args(M=8)
        st = sl.MIN_STEPS["comp" if bad == "m8_compute" else "loads"]
    with pytest.raises((TypeError, ValueError)):
        sl.scan_min_step(*a, gran, st)


def test_reset_launches_covers_the_steps():
    sl.MIN_LAUNCHES["two"] = 4
    sl.reset_launches()
    assert set(sl.MIN_LAUNCHES) == set(sl.MIN_STEPS)
    assert not any(sl.MIN_LAUNCHES.values())


# ---- tools/min_probe.py on the CPU -----------------------------------------

SASS = """
	code for sm_90a
		Function : mstep_two
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0028*/                   LDG.E.U8.CONSTANT R3, desc[UR4][R2.64] ;
        /*0030*/                   PRMT R8, R4, 0x7771, RZ ;
        /*0040*/                   LDS R9, [R8.X4+UR6+0x400] ;
        /*0050*/                   FADD R10, R10, R9 ;
        /*0060*/              @!P0 BRA 0x20 ;
        /*0070*/                   NOP ;
        /*0080*/                   BRA 0x80 ;
		Function : other
        /*0000*/                   LDS R1, [R2] ;
.L_x_7:
        /*0010*/                   LDS R1, [R2] ;
        /*0020*/                   LDS R3, [R2+0x4] ;
        /*0030*/                   IADD3 R2, R2, 0x8, RZ ;
        /*0040*/               @P0 BRA `(.L_x_7) ;
"""


def test_sass_reader_finds_the_lane_loop():
    fns = mp.parse_sass(SASS)
    assert set(fns) == {"mstep_two", "other"}
    st = mp.loop_stats(fns["mstep_two"])   # the BRA-to-itself is no loop body
    assert st["instructions"] == 6 and st["codes"] == 1
    assert st["opcodes_per_code"] == {"BRA": 1, "FADD": 1, "LDG.128": 1,
                                      "LDG.U8": 1, "LDS": 1, "PRMT": 1}
    assert fns["other"][-1][2] == 0x10     # a label's target resolved
    assert mp.loop_stats(fns["other"]) is None   # 2 LDS: no whole code


def test_lookup_wavefronts_count_bank_conflicts():
    """tools/bank_probe.py's stores: r % 32 never meets in a bank (one
    wavefront a lookup), 32 * (r % 8) meets in one bank at 8 words (8), one
    repeated row is a broadcast (1); a 40-code slot is a group of 32 lanes
    and one of 8, a slot of len > gran counts gran codes."""
    from ivfhnsw_tpu_torch.tools.bank_probe import bank_stores
    from ivfhnsw_tpu_torch.utils.roofline import lookup_wavefronts
    rng = np.random.RandomState(5)
    codes = torch.from_numpy(rng.randint(0, 256, (4000, 16)).astype(np.uint8))
    ncodes = torch.from_numpy(rng.randint(0, 256, 4000).astype(np.uint8))
    start = torch.tensor([[0, 64, 1000], [7, 0, 0]])
    length = torch.tensor([[40, 300, 256], [0, 0, 5]], dtype=torch.int32)
    lookups = (40 + 256 + 256 + 5) * 17
    groups = (2 + 8 + 8 + 1) * 17
    st = bank_stores(codes, ncodes)
    assert lookup_wavefronts(*st["free"], start, length, 256) == (lookups,
                                                                  groups)
    assert lookup_wavefronts(*st["way8"], start, length, 256) == (
        lookups, 17 * (8 + 8 + 8 * 8 + 8 * 8 + 5))   # min(lanes, 8) words
    same = (codes[:1].repeat(4000, 1), ncodes[:1].repeat(4000))
    assert lookup_wavefronts(*same, start, length, 256) == (lookups, groups)
    looks, waves = lookup_wavefronts(*st["real"], start, length, 256)
    assert looks == lookups and groups < waves < 8 * groups


def test_in_turns_alternates_and_takes_medians():
    calls = []
    times = iter([1.0, 2.0, 4.0, 3.0] * 2)

    def timer(fn, reps):
        calls.append(fn())
        return next(times)
    a, b, ta, tb = mp.in_turns(lambda: "a", lambda: "b", timer, rounds=2)
    assert calls == ["a", "b", "b", "a"] * 2
    assert (a, b) == (2.0, 3.0) and ta == [1.0, 3.0, 1.0, 3.0]
    assert tb == [2.0, 4.0, 2.0, 4.0] and mp.wins(ta, tb) == 4
    assert mp.wins([1.0, 2.0, 3.0], [1.5, 1.5, 3.0]) == 1


def test_probe_runs_on_the_cpu():
    """The probe on a small M=16 index on the CPU (plain versions, host
    times): one record per kernel, slot width and store, all equal, and
    the split lines."""
    from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
    rng = np.random.RandomState(3)
    centers = rng.randn(24, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 24, 4000)] + rng.randn(4000, 32).astype(
        np.float32)
    idx = IVFADCIndex(IndexConfig(d=32, nc=16, code_size=16), "cpu")
    gen = torch.Generator().manual_seed(0)
    idx.train_centroids(gen, base[:2000], niter=4)
    idx.train_pq(gen, base[:2000], pq_niter=3)
    idx.add_batch(base)
    idx.finalize()
    lines = []
    steps = ["first_port", "comp", "loads", "dp4a_tma_b8", "dp4a_pf_b6"]
    recs = mp.run(idx, base[:6] + 0.1, SearchParams(k=5, nprobe=4,
                                                    max_codes=600),
                  "cpu", batch=6, steps=steps, rounds=1, reps=1,
                  log=lines.append)
    timed = [r for r in recs if "ms" in r]
    assert len(timed) == 2 * 2 * (len(steps) + 1)
    assert all(r["equal_plain"] for r in timed)
    assert {r["name"] for r in timed} == set(steps) | {"production"}
    assert all("over_first_port" in r and 0 <= r["wins"] <= r["pairs"] == 2
               for r in timed if r["name"] != "first_port")
    assert sum(ln.startswith("[mprobe] split") for ln in lines) == 2


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m16", "m16_misaligned", "m8", "b1"])
@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", FULL + ["production"])
def test_full_kernels_bit_equal_on_card(name, gran, case):
    """Each full step and the production kernel: torch.equal to
    adc_scan_slots_min_plain and to the wide kernel's slot minima over
    ragged, clipped, empty and tied slots and an all-empty query; M = 16
    on 16-byte loads, M = 16 one byte off a 16-byte boundary and M = 8 on
    the byte loop; B = 1."""
    _need_card()
    M = 8 if case == "m8" else 16
    B = 1 if case == "b1" else 5
    a = _args("cuda", M=M, gran=gran, B=B, misalign=case == "m16_misaligned")
    if name == "production":
        before = tk.adc_scan_slots_min.launches
        out = tk.adc_scan_slots_min(*a, gran)
        assert tk.adc_scan_slots_min.launches == before + 1
    else:
        before = dict(sl.MIN_LAUNCHES)
        out = sl.scan_min_step(*a, gran, sl.MIN_STEPS[name])
        assert sl.MIN_LAUNCHES == {**before, name: before[name] + 1}
    torch.cuda.synchronize()
    assert torch.equal(out, tk.adc_scan_slots_min_plain(*a, gran))
    wide = tk.adc_scan_slots(*a, gran)
    assert torch.equal(out, wide.view(B, 12, gran).amin(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", [n for n in STEPS if n not in FULL])
def test_measurement_steps_equal_their_plain_on_card(name, gran):
    _need_card()
    a = _args("cuda", gran=gran)
    st = sl.MIN_STEPS[name]
    out = sl.scan_min_step(*a, gran, st)
    torch.cuda.synchronize()
    assert torch.equal(out, sl.min_step_plain(*a, gran, st))
    with pytest.raises(ValueError):           # no 16-byte code rows
        sl.scan_min_step(*_args("cuda", gran=gran, misalign=True), gran, st)


@pytest.mark.cuda
def test_step_occupancy_on_card():
    """Every step reports blocks per SM, its shared memory (the tables and
    the minima at M = 16) and its registers; the 8-block bound holds."""
    _need_card()
    for st in sl.MIN_STEPS.values():
        blocks, smem, regs = sl.min_step_occupancy(st, 16)
        assert 1 <= blocks and 17 * 1024 <= smem < 18 * 1024 and regs > 0
    assert sl.min_step_occupancy(sl.MIN_STEPS["dp4a_tma_b8"], 16)[0] == 8
    assert sl.min_step_occupancy(sl.MIN_STEPS["dp4a_pf_b6"], 16)[0] >= 6

