"""The bank-skewed LUT of the port's scan lab (the skew variants of
ivfhnsw_tpu_torch.ops.cuda.scan_lab): the addressing that the skew kernels
of csrc/scan_lab.cu implement, held by its Python mirror (skewed, skew_word,
lane_copy, lane_row); the two summation orders of the plain scan (fixed:
the production kernels'; rotated: the skew kernels'); the bank probe and
the lookup floor of utils/roofline.py.

The CUDA kernels cannot run on the CPU. What the skew kernels must do is
specified here: which shared-memory word holds which LUT entry, which row a
lane reads at which step (so that the 32 lanes of a warp never meet in a
bank, whatever the codes), and in which order a lane adds its rows (so that
kernel, min kernel and plain version agree bit for bit). The card tests of
tests/test_torch_scan_lab_kernel.py hold the kernels to the plain versions.

This file imports no jax. Tolerances: none (np.array_equal / torch.equal),
except where the rotated and the fixed summation order are compared: two
f32 sums of the same M+2 terms in different orders differ by at most a few
rounding errors of the largest partial sum, asserted as 1e-5 of the sum of
the terms' magnitudes.
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.tools import bank_probe
from ivfhnsw_tpu_torch.utils import roofline

SKEWED_M = [4, 8, 16, 32]
BANKS = 32


def _codes(kind: str, M: int, n: int = 4096) -> np.ndarray:
    """[n, M] code rows: random, or chosen to collide in a row-major LUT."""
    r = np.arange(n)
    if kind == "random":
        return np.random.RandomState(5).randint(0, 256, (n, M))
    col = {"equal": np.full(n, 77), "free": r % 32, "way8": 32 * (r % 8),
           "way32": (32 * r) % 256}[kind]
    return np.repeat(col[:, None], M, axis=1)


@pytest.mark.parametrize("M", SKEWED_M)
def test_layout_is_a_bijection_onto_256_x_32_words(M):
    C = BANKS // M
    words = [sl.skew_word(k, m, c, M) for k in range(256) for m in range(M)
             for c in range(C)]
    assert sorted(words) == list(range(256 * BANKS))


@pytest.mark.parametrize("M", SKEWED_M)
def test_a_row_of_a_copy_lives_in_one_bank_alone(M):
    C = BANKS // M
    owner = {}
    for m in range(M):
        for c in range(C):
            banks = {sl.skew_word(k, m, c, M) % BANKS for k in range(256)}
            assert banks == {m * C + c}
            owner[m * C + c] = (m, c)
    assert len(owner) == BANKS


@pytest.mark.parametrize("M", SKEWED_M)
def test_a_lane_visits_every_row_once(M):
    for l in (0, 1, M - 1, M, 31, 32, 1000, 1023):
        assert sorted(sl.lane_row(l, t, M) for t in range(M)) == list(range(M))
        assert sl.lane_row(l, 0, M) == l % M


@pytest.mark.parametrize("kind", ["random", "equal", "free", "way8", "way32"])
@pytest.mark.parametrize("M", SKEWED_M)
def test_every_step_of_a_warp_hits_32_distinct_banks(M, kind):
    """32 consecutive lanes l (a warp of either skew kernel: l0 a multiple
    of 32), lane l at row start + l: at every step the 32 word addresses
    fall in 32 different banks, whatever the codes."""
    codes = _codes(kind, M)
    for start, l0 in ((0, 0), (17, 32), (1001, 224), (3000, 992)):
        for t in range(M):
            words = []
            for l in range(l0, l0 + 32):
                m = sl.lane_row(l, t, M)
                words.append(sl.skew_word(int(codes[start + l, m]), m,
                                          sl.lane_copy(l, M), M))
            assert len({w % BANKS for w in words}) == 32


@pytest.mark.parametrize("kind,worst", [("free", 1), ("way8", 8),
                                        ("way32", 8), ("equal", 1)])
def test_row_major_layout_conflicts_on_the_probe_stores(kind, worst):
    """The production layout (entry k of row m at word m*256 + k, all
    lanes of a warp in the same row): the distinct words in
    the fullest bank are 1 on the conflict-free store, 8 on the 8-way one.
    (way32 has only 8 distinct multiples of 32 below 256.)"""
    codes = _codes(kind, 16)
    for m in (0, 7):
        words = [m * 256 + int(codes[100 + l, m]) for l in range(32)]
        per_bank = {}
        for w in words:
            per_bank.setdefault(w % BANKS, set()).add(w)
        assert max(len(s) for s in per_bank.values()) == worst


def test_skewed_is_true_where_m_divides_the_banks():
    assert [M for M in range(1, 70) if sl.skewed(M)] == SKEWED_M
    for bad in ((0, 0, 0, 12), (256, 0, 0, 16), (0, 16, 0, 16),
                (0, 0, 2, 16), (0, 0, 0, 2)):
        with pytest.raises(ValueError):
            sl.skew_word(*bad)


def _scan_args(M, gran, seed=2):
    """2 queries x 5 slots: empty, one code, partial at an odd start, full,
    a partial slot ending at the store's last row."""
    rng = np.random.RandomState(seed)
    B, N = 2, 3 * gran + 101
    lens = [0, 1, gran // 2 + 3, gran, 77]
    starts = [0, 17, 101, 5, N - 77]
    lut = rng.randn(B, M, 256).astype(np.float32) * 3
    ntab = (rng.rand(256) * 10).astype(np.float32)
    codes = rng.randint(0, 256, (N, M)).astype(np.uint8)
    ncodes = rng.randint(0, 256, N).astype(np.uint8)
    start = np.array([starts] * B, np.int64)
    start[1, 2] += 40
    length = np.array([lens] * B, np.int32)
    bias = rng.randn(B, len(lens)).astype(np.float32)
    return lut, ntab, codes, ncodes, start, length, bias


def _numpy_scan(args, gran, rotated):
    """The scan by hand in numpy f32, one rounded add per term: bias, norm,
    then rows (t + l) mod M (rotated) or t, for t = 0..M-1. Also returns
    the sum of the terms' magnitudes."""
    lut, ntab, codes, ncodes, start, length, bias = args
    B, S = start.shape
    M = codes.shape[1]
    out = np.full((B, S * gran), np.inf, np.float32)
    mag = np.zeros((B, S * gran), np.float32)
    for b in range(B):
        for s in range(S):
            n = int(length[b, s])
            l = np.arange(n)
            r = int(start[b, s]) + l
            nrm = ntab[ncodes[r]]
            acc = (np.float32(bias[b, s]) + nrm).astype(np.float32)
            tot = np.abs(bias[b, s]) + np.abs(nrm)
            for t in range(M):
                m = (t + l) % M if rotated else np.full(n, t)
                term = lut[b, m, codes[r, m]]
                acc = (acc + term).astype(np.float32)
                tot = tot + np.abs(term)
            out[b, s * gran:s * gran + n] = acc
            mag[b, s * gran:s * gran + n] = tot
    return out, mag


def _t(args):
    return [torch.from_numpy(a) for a in args]


GRAN_M = [(g, M) for g in (256, 1024) for M in (8, 16, 12)]


@pytest.mark.parametrize("gran,M", GRAN_M)
def test_plain_rotated_equals_the_rotated_numpy_loop_bit_for_bit(gran, M):
    """rotate=True: rows in the order (t + l) mod M, at any M."""
    args = _scan_args(M, gran)
    ref, _ = _numpy_scan(args, gran, rotated=True)
    out = tk.adc_scan_slots_plain(*_t(args), gran, rotate=True).numpy()
    assert np.array_equal(out, ref)
    assert np.isinf(out[:, :gran]).all() and np.isfinite(out[:, gran]).all()


@pytest.mark.parametrize("gran,M", GRAN_M)
def test_plain_equals_the_fixed_order_numpy_loop_bit_for_bit(gran, M):
    """The default, the production kernels' order: m = 0..M-1."""
    args = _scan_args(M, gran)
    ref, _ = _numpy_scan(args, gran, rotated=False)
    out = tk.adc_scan_slots_plain(*_t(args), gran).numpy()
    assert np.array_equal(out, ref)
    assert np.array_equal(out, tk.adc_scan_slots_plain(
        *_t(args), gran, rotate=False).numpy())


@pytest.mark.parametrize("gran,M", GRAN_M)
def test_the_two_orders_differ_by_rounding_only(gran, M):
    args = _scan_args(M, gran)
    a, mag = _numpy_scan(args, gran, rotated=True)
    rot = tk.adc_scan_slots_plain(*_t(args), gran, rotate=True).numpy()
    fix = tk.adc_scan_slots_plain(*_t(args), gran).numpy()
    fin = np.isfinite(fix)
    assert np.array_equal(np.isfinite(rot), fin)
    assert (np.abs(rot[fin] - fix[fin]) <= 1e-5 * mag[fin]).all()
    assert not np.array_equal(rot, fix)   # they do differ: the order is real


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("gran,M", GRAN_M)
def test_min_plain_is_the_slot_amin(gran, M, rotate):
    args = _t(_scan_args(M, gran))
    wide = tk.adc_scan_slots_plain(*args, gran, rotate=rotate)
    mins = tk.adc_scan_slots_min_plain(*args, gran, rotate=rotate)
    assert torch.equal(mins, wide.view(2, 5, gran).amin(-1))
    assert torch.isinf(mins[:, 0]).all() and torch.isfinite(mins[:, 1:]).all()


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("gran,M", GRAN_M)
def test_a_slot_rescanned_alone_gives_the_same_lanes(gran, M, rotate):
    """The two-phase rescan gathers chosen slots into a new schedule; a
    lane's sum (and its rotation, which depends on its place in the slot
    only) does not change."""
    args = _t(_scan_args(M, gran))
    wide = tk.adc_scan_slots_plain(*args, gran, rotate).view(2, 5, gran)
    pick = torch.tensor([[3, 1], [4, 2]])
    st, ln, bs = (torch.gather(x, 1, pick) for x in args[4:])
    again = tk.adc_scan_slots_plain(*args[:4], st, ln, bs, gran,
                                    rotate).view(2, 2, gran)
    assert torch.equal(again, torch.gather(
        wide, 1, pick[:, :, None].expand(2, 2, gran)))


def test_probe_stores_have_the_stores_shape_and_the_stated_banks():
    codes = torch.from_numpy(_codes("random", 16).astype(np.uint8))
    ncodes = torch.arange(4096).to(torch.uint8)
    stores = bank_probe.bank_stores(codes, ncodes)
    assert list(stores) == list(bank_probe.STORES) == ["real", "free", "way8"]
    assert stores["real"][0] is codes and stores["real"][1] is ncodes
    for name, (c, n) in stores.items():
        assert c.shape == codes.shape and c.dtype == torch.uint8
        assert n.shape == ncodes.shape and n.dtype == torch.uint8
        assert c.is_contiguous()
    r = np.arange(4096)
    for name, col in (("free", r % 32), ("way8", 32 * (r % 8))):
        c, n = stores[name]
        assert np.array_equal(n.numpy(), col)
        assert np.array_equal(c.numpy(), np.repeat(col[:, None], 16, 1))


def test_lookup_floor_is_none_off_the_card_and_scan_bound_carries_it():
    assert roofline.lookup_ms(1e9, torch.device("cpu")) is None
    args = _t(_scan_args(16, 256))
    b = roofline.scan_bound(args, 2 * 5 * 256, 17, 17)
    assert set(b) == {"bound_ms", "bound_by", "lookup_ms"}
    assert b["lookup_ms"] is None and b["bound_ms"] > 0
    wb = roofline.scan_bound(args, 2 * 5 * 256, 17, 17, bins=True)
    assert wb["bound_ms"] == pytest.approx(
        b["bound_ms"] + 2 * 5 * 256 // 32 * 4 / 3.35e9)


def test_bank_probe_runs_on_a_cpu_index():
    """The probe end to end at a tiny size on the CPU (plain versions, host
    times): one record per kernel and width, equal to plain on every
    store."""
    from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
    rng = np.random.RandomState(3)
    centers = rng.randn(24, 16).astype(np.float32) * 5
    base = centers[rng.randint(0, 24, 3000)] + rng.randn(3000, 16).astype(
        np.float32)
    idx = IVFADCIndex(IndexConfig(d=16, nc=32, code_size=8), "cpu")
    gen = torch.Generator().manual_seed(0)
    idx.train_centroids(gen, base[:2000], niter=5)
    idx.train_pq(gen, base[:2000], pq_niter=3)
    idx.add_batch(base)
    idx.finalize()
    lines = []
    recs = bank_probe.run(idx, base[:6] + 0.1,
                          SearchParams(k=5, nprobe=4, max_codes=300), "cpu",
                          batch=6, reps=1, log=lines.append)
    turns = [r for r in recs if "ms_in_turns" in r]
    recs = [r for r in recs if "ms_in_turns" not in r]
    assert [r["name"] for r in turns] == [
        "adc_scan_slots_gran256_vs_lab_direct256",
        "adc_scan_slots_min_gran256_vs_lab_direct256_min",
        "adc_scan_slots_gran1024_vs_lab_direct1024",
        "adc_scan_slots_min_gran1024_vs_lab_direct1024_min"]
    assert all(len(v) == 8 for r in turns for v in r["ms_in_turns"].values())
    assert [r["name"] for r in recs] == [
        "adc_scan_slots_gran256", "adc_scan_slots_min_gran256",
        "lab_direct256", "lab_direct256_min", "lab_skew256",
        "lab_skew256_min", "adc_scan_slots_gran1024",
        "adc_scan_slots_min_gran1024", "lab_direct1024",
        "lab_direct1024_min", "lab_skew1024", "lab_skew1024_min"]
    assert len(lines) == 16 and all(ln.startswith("[banks] ") for ln in lines)
    for r in recs:
        assert r["timer"] == "host" and set(r["ms"]) == {"real", "free",
                                                         "way8", "hot"}
        assert all(r["equal_plain"].values())
