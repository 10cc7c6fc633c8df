"""The ADC scan wrappers of the PyTorch port (ivfhnsw_tpu_torch.ops.cuda.
adc_scan.adc_scan_slots and adc_scan_slots_min): dispatch, argument checks
and the plain versions on the CPU, the CUDA kernels against their plain
versions on a card, and the two-phase top-k against the wide one.

This file imports no jax, so it also runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scan_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false.
Tolerance on the card: identical +inf pattern, finite lanes within
rtol=1e-4, atol=1e-3 (the kernel and the plain version sum in the same
order, so they normally agree exactly). The min-scan kernel is held to
bit equality (``torch.equal``) with its plain version and with the wide
kernel's per-slot minima: both kernels share one per-lane sum.
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk

RTOL, ATOL = 1e-4, 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _small_args(device="cpu", M=8, gran=256):
    """3 queries x 4 slots: empty, one code, half full, full."""
    rng = np.random.RandomState(1)
    B, S, N = 3, 4, 2000
    lut = torch.from_numpy(rng.randn(B, M, 256).astype(np.float32))
    ntab = torch.from_numpy(rng.rand(256).astype(np.float32))
    codes = torch.from_numpy(rng.randint(0, 256, (N, M)).astype(np.uint8))
    ncodes = torch.from_numpy(rng.randint(0, 256, N).astype(np.uint8))
    start = torch.from_numpy(rng.randint(0, N - gran, (B, S)).astype(np.int64))
    length = torch.from_numpy(
        np.array([[0, 1, gran // 2, gran]] * B, np.int32))
    bias = torch.from_numpy(rng.randn(B, S).astype(np.float32))
    return [x.to(device) for x in (lut, ntab, codes, ncodes, start, length,
                                   bias)] + [gran]


def test_dispatcher_cpu_uses_plain_and_counts_no_launch():
    args = _small_args()
    before = tk.adc_scan_slots.launches
    out = tk.adc_scan_slots(*args)
    assert tk.adc_scan_slots.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  tk.adc_scan_slots_plain(*args).numpy())
    out = out.numpy().reshape(3, 4, 256)
    assert np.isinf(out[:, 0]).all()                        # empty slot
    assert np.isfinite(out[:, 1, :1]).all() and np.isinf(out[:, 1, 1:]).all()
    assert np.isfinite(out[:, 3]).all()                     # full slot


def test_plain_scan_values_by_hand():
    lut, ntab, codes, ncodes, start, length, bias, gran = _small_args()
    out = tk.adc_scan_slots_plain(lut, ntab, codes, ncodes, start, length,
                                  bias, gran).numpy()
    b, s, l = 2, 2, 77
    r = int(start[b, s]) + l
    # f32, in the kernels' order: bias, norm, then m = 0..M-1
    expect = np.float32(bias[b, s]) + np.float32(ntab[int(ncodes[r])])
    for m in range(8):
        expect = np.float32(expect + np.float32(lut[b, m, int(codes[r, m])]))
    assert out[b, s * gran + l] == expect


def test_plain_scan_empty_store_is_all_inf():
    args = _small_args()
    args[2], args[3] = args[2][:0], args[3][:0]
    args[5] = torch.zeros_like(args[5])
    assert torch.isinf(tk.adc_scan_slots(*args)).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device",
                                 "meta"])
def test_dispatcher_rejects_what_the_kernel_does_not_take(bad):
    args = _small_args()
    if bad == "dtype":
        args[4] = args[4].to(torch.int32)                   # start
    elif bad == "shape":
        args[0] = args[0][:, :, :128].contiguous()          # lut
    elif bad == "contiguous":
        args[2] = torch.cat([args[2], args[2]], 1)[:, ::2]  # codes
    elif bad == "device":
        args[6] = args[6].to("meta")                        # bias
    else:
        args = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises((TypeError, ValueError)):
        tk.adc_scan_slots(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("gran", [256, 1024])
def test_kernel_matches_plain_on_card(M, gran):
    """M=16 takes the kernel's 16-byte code loads, M=8 its byte loop."""
    _need_card()
    args = _small_args("cuda", M=M, gran=gran)
    before = tk.adc_scan_slots.launches
    out = tk.adc_scan_slots(*args)
    torch.cuda.synchronize()
    assert tk.adc_scan_slots.launches == before + 1
    ref = tk.adc_scan_slots_plain(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL)


def _card_args(M, gran, B, store, device):
    """B queries x 11 slots over a 5003-row store: empty (alone, in a run
    in the middle and in a run at the end), one code, partial and full
    slots at odd start rows, a slot ending at the store's last row; query
    0's schedule is all empty when B > 1. ``store`` picks the codes of
    tools/bank_probe.py::bank_stores."""
    from ivfhnsw_tpu_torch.tools.bank_probe import bank_stores
    rng = np.random.RandomState(7)
    N = 5003
    lens = [0, 1, gran // 2 + 3, 0, 0, 0, gran, 77, gran - 5, 0, 0]
    starts = [0, 17, 101, 0, 0, 0, 5, N - 77, 1001, 0, 0]
    lut = torch.from_numpy(rng.randn(B, M, 256).astype(np.float32) * 3)
    ntab = torch.from_numpy(rng.rand(256).astype(np.float32) * 10)
    codes = torch.from_numpy(rng.randint(0, 256, (N, M)).astype(np.uint8))
    ncodes = torch.from_numpy(rng.randint(0, 256, N).astype(np.uint8))
    codes, ncodes = bank_stores(codes, ncodes)[store]
    start = torch.tensor([starts] * B, dtype=torch.int64)
    start[B // 2:, 2] += 40
    length = torch.tensor([lens] * B, dtype=torch.int32)
    if B > 1:
        length[0] = 0
    bias = torch.from_numpy(rng.randn(B, len(lens)).astype(np.float32))
    return [x.to(device) for x in (lut, ntab, codes, ncodes, start, length,
                                   bias)] + [gran]


def test_card_args_on_cpu_cover_empty_runs_and_the_stores_end():
    """The card tests' inputs, through the plain versions on the CPU."""
    args = _card_args(12, 256, 7, "way8", "cpu")
    out = tk.adc_scan_slots(*args).view(7, 11, 256)
    assert torch.isinf(out[0]).all()                        # all-empty query
    assert torch.isinf(out[1:, [0, 3, 4, 5, 9, 10]]).all()   # empty runs
    assert torch.isfinite(out[1:, 6]).all()                  # full slot
    assert torch.isfinite(out[1:, 7, :77]).all()             # the store's end
    assert torch.equal(tk.adc_scan_slots_min(*args), out.amin(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("store", ["real", "free", "way8"])
@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("M", [4, 8, 12, 16, 32])
def test_kernels_bit_equal_to_plain_on_card(M, gran, store, B):
    """Both kernels torch.equal to their plain versions, the min kernel to
    the wide kernel's slot minima: M = 16 on the 16-byte loads, any other M
    on the byte loop; empty, partial and full slots, runs of empty slots
    (one fill), odd start rows, the store's last row; stores whose lookups
    never, randomly or always meet in a bank; B = 1 and B = 7."""
    _need_card()
    args = _card_args(M, gran, B, store, "cuda")
    wide = tk.adc_scan_slots(*args)
    mins = tk.adc_scan_slots_min(*args)
    torch.cuda.synchronize()
    assert torch.equal(wide, tk.adc_scan_slots_plain(*args))
    assert torch.equal(mins, tk.adc_scan_slots_min_plain(*args))
    assert torch.equal(mins, wide.view(B, 11, gran).amin(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("gran", [256, 1024])
def test_kernels_on_a_store_off_a_16_byte_boundary_on_card(gran):
    """M = 16 codes that start one byte into their buffer take the byte
    loop in place of the 16-byte loads; the output's slots then start off
    a 16-byte boundary for no width, so this also holds the fill's
    alignment test."""
    _need_card()
    args = _card_args(16, gran, 3, "real", "cuda")
    buf = torch.zeros(args[2].numel() + 1, dtype=torch.uint8, device="cuda")
    buf[1:] = args[2].reshape(-1)
    args[2] = buf[1:].view(args[2].shape)
    assert args[2].data_ptr() % 16 == 1 and args[2].is_contiguous()
    assert torch.equal(tk.adc_scan_slots(*args),
                       tk.adc_scan_slots_plain(*args))
    assert torch.equal(tk.adc_scan_slots_min(*args),
                       tk.adc_scan_slots_min_plain(*args))


@pytest.mark.cuda
def test_kernel_rejects_cpu_mixed_with_card():
    _need_card()
    args = _small_args("cuda")
    args[2] = args[2].cpu()
    with pytest.raises(ValueError):
        tk.adc_scan_slots(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["chunk", "quad"])
def test_fused_engine_matches_torch_engine_on_card(layout):
    """A small index built on the card: engine "fused" (the kernel) against
    engine "torch", labels differing only at equal distances."""
    _need_card()
    rng = np.random.RandomState(3)
    centers = rng.randn(48, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, 9000)] + rng.randn(9000, 32).astype(
        np.float32)
    queries = base[:40] + 0.1
    idx = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx.train_centroids(gen, base[:4000], niter=8)
    idx.train_pq(gen, base[:4000], pq_niter=5)
    idx.add_batch(base)
    idx.finalize()
    p = SearchParams(k=10, nprobe=16, max_codes=300)
    idx.engine = "torch"
    d1, l1 = idx.search(queries, p)
    idx.engine, idx.scan_layout = "fused", layout
    before = tk.adc_scan_slots.launches
    d2, l2 = idx.search(queries, p)
    assert tk.adc_scan_slots.launches > before
    assert_same(d1, l1, d2, l2)


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


def _wide_minima(args):
    lut, ntab, codes, ncodes, start, length, bias, gran = args
    B, S = start.shape
    return tk.adc_scan_slots(*args).view(B, S, gran).amin(-1)


@pytest.mark.parametrize("gran", [256, 1024])
def test_min_dispatcher_cpu_is_the_wide_slot_minimum(gran):
    """On CPU tensors adc_scan_slots_min runs its plain version, counts no
    launch, and equals the wide scan's per-slot amin bit for bit (+inf for
    the empty slot)."""
    args = _small_args(gran=gran)
    before = tk.adc_scan_slots_min.launches
    mins = tk.adc_scan_slots_min(*args)
    assert tk.adc_scan_slots_min.launches == before
    assert mins.shape == (3, 4)
    assert torch.equal(mins, _wide_minima(args))
    assert torch.isinf(mins[:, 0]).all() and torch.isfinite(mins[:, 1:]).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "gran"])
def test_min_dispatcher_rejects_what_the_kernel_does_not_take(bad):
    args = _small_args()
    if bad == "dtype":
        args[5] = args[5].long()                            # length
    elif bad == "shape":
        args[6] = args[6][:, :2].contiguous()               # bias
    elif bad == "device":
        args[1] = args[1].to("meta")                        # norm_tab
    else:
        args[7] = 0
    with pytest.raises((TypeError, ValueError)):
        tk.adc_scan_slots_min(*args)


def _small_index(device, nb=9000, seed=3):
    """A small clustered index (d=32, nc=64, M=8) built on ``device``."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(48, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, nb)] + rng.randn(nb, 32).astype(
        np.float32)
    idx = IVFADCIndex(IndexConfig(d=32, nc=64, code_size=8), device)
    gen = torch.Generator(device=device).manual_seed(0)
    idx.train_centroids(gen, base[:4000], niter=8)
    idx.train_pq(gen, base[:4000], pq_niter=5)
    idx.add_batch(base)
    idx.finalize()
    return idx, base


@pytest.mark.parametrize("k", [1, 10, 64])
def test_two_phase_matches_wide_cpu(k):
    """scan_topk="twophase" (minima, k best slots, rescan) returns the wide
    engine's distances on the CPU; k=64 exceeds some queries' slot count,
    so their tails are +inf with label -1 in both."""
    idx, base = _small_index("cpu")
    p = SearchParams(k=k, nprobe=4, max_codes=0)
    idx.engine, idx.scan_layout = "fused", "chunk"
    d1, l1 = idx.search(base[:30] + 0.1, p)
    idx.scan_topk = "twophase"
    d2, l2 = idx.search(base[:30] + 0.1, p)
    assert_same(d1, l1, d2, l2)
    np.testing.assert_array_equal(l2 < 0, np.isinf(d2))


def test_unknown_scan_topk_raises():
    idx, base = _small_index("cpu", nb=3000)
    idx.scan_topk = "fast"
    with pytest.raises(ValueError):
        idx.search(base[:4], SearchParams(k=5, nprobe=4, max_codes=0))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("gran", [256, 1024])
def test_min_kernel_bit_equal_on_card(M, gran):
    """The min-scan kernel equals its plain version and the wide kernel's
    per-slot minima bit for bit; M=16 takes the 16-byte code loads."""
    _need_card()
    args = _small_args("cuda", M=M, gran=gran)
    before = tk.adc_scan_slots_min.launches
    mins = tk.adc_scan_slots_min(*args)
    torch.cuda.synchronize()
    assert tk.adc_scan_slots_min.launches == before + 1
    assert torch.equal(mins, tk.adc_scan_slots_min_plain(*args))
    assert torch.equal(mins, _wide_minima(args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["chunk", "quad"])
def test_two_phase_matches_wide_on_card(layout):
    """A 200k-code index on the card: the two-phase top-k (min kernel, then
    the wide kernel on the chosen slots) against the wide engine, at k=10
    with a max_codes budget and at k=64 without."""
    _need_card()
    idx, base = _small_index("cuda", nb=200_000)
    queries = base[:256] + 0.1
    idx.engine, idx.scan_layout = "fused", layout
    for p in (SearchParams(k=10, nprobe=16, max_codes=3000),
              SearchParams(k=64, nprobe=8, max_codes=0)):
        idx.scan_topk = "wide"
        d1, l1 = idx.search(queries, p)
        idx.scan_topk = "twophase"
        before = tk.adc_scan_slots_min.launches
        d2, l2 = idx.search(queries, p)
        assert tk.adc_scan_slots_min.launches > before
        assert_same(d1, l1, d2, l2)
