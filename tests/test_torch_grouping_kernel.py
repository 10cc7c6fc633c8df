"""The grouping scan wrapper of the PyTorch port (ivfhnsw_tpu_torch.ops.
cuda.grouping_scan.grouping_scan_slots) and the deterministic segment sum
(ivfhnsw_tpu_torch.ops.segment.segment_sum): the plain versions on the CPU
against numpy formulas, and on a card the CUDA kernel against its plain
version, the fused grouping engine against the torch engine, and k-means
run twice from one seed.

This file imports no jax, so it also runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grouping_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false.

Tolerances: the plain scan against the float64 numpy formula rtol 1e-6,
atol 1e-5 (float32 rounding of ~20 terms of magnitude ~3); the kernel
against the plain version an identical +inf pattern and finite lanes within
rtol=1e-4, atol=1e-3 (both sum in one order, so they normally agree
exactly); the fused engine against the torch engine rtol=1e-4, atol=1e-3
with labels differing only at equal distances; segment sums against a
float64 ``np.add.at`` within 1e-5 relative (of the sum of magnitudes), and
bit-equal to a sequential float32 sum in input order on the CPU; k-means
centroids of two runs on the card ``torch.equal``.
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch import IndexConfig, IVFADCGroupingIndex, SearchParams
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
from ivfhnsw_tpu_torch.ops.segment import segment_sum

RTOL, ATOL = 1e-4, 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _args(device="cpu", M=8, gran=256, P=3, nsubc=4):
    """3 queries x 5 slots: empty, one code, half full, full, and a full
    slot of a probe whose subgroups 0 and 2 are pruned (+inf term2)."""
    rng = np.random.RandomState(2)
    B, S, N = 3, 5, 3000
    lut = rng.randn(B, M, 256).astype(np.float32)
    ntab = rng.rand(256).astype(np.float32)
    t2 = rng.randn(B, P, nsubc).astype(np.float32)
    t2[:, 2, [0, 2]] = np.inf
    codes = rng.randint(0, 256, (N, M)).astype(np.uint8)
    ncodes = rng.randint(0, 256, N).astype(np.uint8)
    subc = rng.randint(0, nsubc, N).astype(np.uint8)
    start = rng.randint(0, N - gran, (B, S)).astype(np.int64)
    length = np.array([[0, 1, gran // 2, gran, gran]] * B, np.int32)
    bias = rng.randn(B, S).astype(np.float32)
    seg = np.array([[0, 1, 0, 1, 2]] * B, np.int32)
    arrs = [torch.from_numpy(a).to(device) for a in
            (lut, ntab, t2, codes, ncodes, subc, start, length, bias, seg)]
    return arrs + [gran]


def _numpy_scan(lut, ntab, t2, codes, ncodes, subc, start, length, bias,
                seg, gran):
    """The kernel's function, written out lane by lane in float64."""
    B, S = start.shape
    out = np.full((B, S * gran), np.inf)
    for b in range(B):
        for s in range(S):
            for ln in range(length[b, s]):
                r = start[b, s] + ln
                out[b, s * gran + ln] = (
                    float(bias[b, s]) + ntab[ncodes[r]]
                    + t2[b, seg[b, s], subc[r]]
                    + sum(float(lut[b, m, codes[r, m]])
                          for m in range(codes.shape[1])))
    return out


def test_plain_matches_numpy_formula():
    args = _args()
    out = tg.grouping_scan_slots_plain(*args).numpy()
    ref = _numpy_scan(*[a.numpy() for a in args[:-1]], args[-1])
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-6, atol=1e-5)
    out = out.reshape(3, 5, 256)
    assert np.isinf(out[:, 0]).all()                        # empty slot
    assert np.isfinite(out[:, 1, :1]).all() and np.isinf(out[:, 1, 1:]).all()
    assert np.isfinite(out[:, 3]).all()                     # full slot
    # The pruned probe's slot: +inf exactly on subgroups 0 and 2, no NaN.
    sub = args[5].numpy()[args[6].numpy()[0, 4]:][:256]
    np.testing.assert_array_equal(np.isinf(out[0, 4]), np.isin(sub, [0, 2]))
    assert not np.isnan(out).any()


def test_dispatcher_cpu_uses_plain_and_counts_no_launch():
    args = _args(M=16, gran=1024)
    before = tg.grouping_scan_slots.launches
    out = tg.grouping_scan_slots(*args)
    assert tg.grouping_scan_slots.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  tg.grouping_scan_slots_plain(*args).numpy())


def test_plain_scan_empty_store_is_all_inf():
    args = _args()
    for i in (3, 4, 5):                                     # codes, ncodes, subc
        args[i] = args[i][:0]
    args[7] = torch.zeros_like(args[7])
    assert torch.isinf(tg.grouping_scan_slots(*args)).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device",
                                 "smem"])
def test_dispatcher_rejects_what_the_kernel_does_not_take(bad):
    args = _args()
    if bad == "dtype":
        args[9] = args[9].long()                            # seg
    elif bad == "shape":
        args[5] = args[5][:-1]                              # subc
    elif bad == "contiguous":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":
        args[8] = args[8].to("meta")                        # bias
    else:                                                   # 240 KB of t2
        args[2] = torch.zeros((3, 3, 20000))
    with pytest.raises((TypeError, ValueError)):
        tg.grouping_scan_slots(*args)


def test_smem_budget_of_the_flagship_fits():
    """LUT + norm + term2 at M=16, nprobe=32, nsubc=64: 25 KB per block,
    below the 48 KB a launch gets without opting in."""
    assert tg.smem_bytes(16, 32, 64) == (17 * 256 + 32 * 64) * 4 < 48 * 1024


@pytest.mark.parametrize("shape", [(), (5,)], ids=["1d", "2d"])
def test_segment_sum_matches_numpy(shape):
    """Against float64 np.add.at, empty segments included (0)."""
    rng = np.random.RandomState(4)
    n, nseg = 4000, 50
    vals = (rng.randn(n, *shape) * 10).astype(np.float32)
    keys = rng.randint(0, nseg, n)
    keys[keys == 7] = 8                                     # segment 7 empty
    out = segment_sum(torch.from_numpy(vals), torch.from_numpy(keys),
                      nseg).numpy()
    ref = np.zeros((nseg, *shape))
    np.add.at(ref, keys, vals.astype(np.float64))
    mag = np.zeros((nseg, *shape))
    np.add.at(mag, keys, np.abs(vals.astype(np.float64)))
    assert out.shape == (nseg, *shape) and out.dtype == np.float32
    assert (np.abs(out - ref) <= 1e-5 * mag).all()
    assert (out[7] == 0).all() and (out[nseg - 1] != 0).all()


def test_segment_sum_order_is_input_order():
    """The sums are sequential float32 sums in input order: the order of
    summation is fixed by the data (bit-equal on the CPU)."""
    rng = np.random.RandomState(5)
    vals = (rng.randn(3000, 3) * 100).astype(np.float32)
    keys = rng.randint(0, 6, 3000)
    ref = np.zeros((6, 3), np.float32)
    for v, k in zip(vals, keys):
        ref[k] += v
    out = segment_sum(torch.from_numpy(vals), torch.from_numpy(keys), 6)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("gran", [256, 1024])
def test_kernel_matches_plain_on_card(M, gran):
    """M=16 takes the kernel's 16-byte code loads, M=8 its byte loop."""
    _need_card()
    args = _args("cuda", M=M, gran=gran)
    before = tg.grouping_scan_slots.launches
    out = tg.grouping_scan_slots(*args)
    torch.cuda.synchronize()
    assert tg.grouping_scan_slots.launches == before + 1
    ref = tg.grouping_scan_slots_plain(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    assert not torch.isnan(out).any()
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_opts_into_large_shared_memory_on_card():
    """A term2 table of 128 probes x 256 subgroups (128 KB) needs more than
    the default 48 KB of shared memory."""
    _need_card()
    args = _args("cuda", M=16, P=128, nsubc=256)
    args[9] = torch.full_like(args[9], 127)
    out = tg.grouping_scan_slots(*args)
    torch.cuda.synchronize()
    ref = tg.grouping_scan_slots_plain(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_cpu_mixed_with_card():
    _need_card()
    args = _args("cuda")
    args[5] = args[5].cpu()
    with pytest.raises(ValueError):
        tg.grouping_scan_slots(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["chunk", "quad"])
def test_fused_grouping_matches_torch_engine_on_card(layout):
    """A small OPQ grouping index built on the card: engine "fused" (the
    kernel) against engine "torch", with and without pruning."""
    _need_card()
    rng = np.random.RandomState(3)
    centers = rng.randn(40, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, 8000)] + rng.randn(8000, 32).astype(
        np.float32)
    queries = base[:40] + 0.1
    idx = IVFADCGroupingIndex(
        IndexConfig(d=32, nc=32, code_size=8, nsubc=8, do_opq=True), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx.train_centroids(gen, base[:4000], niter=8)
    idx.compute_neighbor_centroids()
    idx.train_pq(gen, base[:3000], pq_niter=5, opq_niter=4)
    idx.add(base)
    idx.finalize()
    idx.compute_inter_centroid_dists()
    for pruning in (False, True):
        p = SearchParams(k=10, nprobe=8, max_codes=600, do_pruning=pruning)
        idx.engine = "torch"
        d1, l1 = idx.search(queries, p)
        idx.engine, idx.scan_layout = "fused", layout
        before = tg.grouping_scan_slots.launches
        d2, l2 = idx.search(queries, p)
        assert tg.grouping_scan_slots.launches > before
        np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
        mism = l1 != l2
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_segment_sum_is_deterministic_on_card():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    vals = torch.randn((1 << 20, 9), device="cuda", generator=g) * 100
    keys = torch.randint(0, 4096, (1 << 20,), device="cuda", generator=g)
    a = segment_sum(vals, keys, 4096)
    b = segment_sum(vals, keys, 4096)
    assert torch.equal(a, b)
    ref = torch.zeros((4096, 9), dtype=torch.float64, device="cuda")
    ref.index_add_(0, keys, vals.double())
    torch.testing.assert_close(a.double(), ref, rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
def test_kmeans_is_deterministic_on_card():
    """The primary point's centroid training (200k learn rows, nc=4096,
    setup_quantizer's 15 iterations), twice from one seed: the same bits."""
    _need_card()
    from ivfhnsw_tpu_torch.ops.kmeans import kmeans
    rng = np.random.RandomState(0)
    centers = rng.randn(4096, 128).astype(np.float32) * 4.0
    a = rng.randint(0, 4096, 200_000)
    learn = torch.tensor(centers[a] + rng.randn(200_000, 128).astype(
        np.float32), device="cuda")
    c1, _ = kmeans(torch.Generator(device="cuda").manual_seed(0), learn,
                   4096, niter=15)
    c2, _ = kmeans(torch.Generator(device="cuda").manual_seed(0), learn,
                   4096, niter=15)
    assert torch.equal(c1, c2)
