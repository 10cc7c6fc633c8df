"""The exact top-1 kernel of the PyTorch port (``csrc/assign_min.cu`` via
``ivfhnsw_tpu_torch.ops.cuda.assign_min.top1_update``) against its plain
version on a card, and ``streaming_topk_l2(k=1)`` launching it.

This file imports no jax, so it also runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_assign_min_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false. On the
card the kernel reads the GEMM output the plain version reads and rounds
the same two adds, so both are held bit for bit (``torch.equal``),
distances and ids.
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch.ops import distances as td
from ivfhnsw_tpu_torch.ops.cuda import assign_min as am


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _both(ip, qsq, psq, best_d, best_i, off):
    """The kernel and the plain version on the same inputs; returns both
    (best_d, best_i) pairs."""
    k = (best_d.clone(), best_i.clone())
    p = (best_d.clone(), best_i.clone())
    am.top1_update(ip, qsq, psq, *k, off)
    am.top1_update_plain(ip, qsq, psq, *p, off)
    torch.cuda.synchronize()
    return k, p


def test_cpu_tensors_take_the_plain_version():
    """Jax-free twin of the CPU dispatch check: no launch counted, the
    plain version's result."""
    rng = np.random.RandomState(0)
    ip = torch.from_numpy(rng.randn(5, 9).astype(np.float32))
    qsq, psq = torch.ones(5), torch.from_numpy(rng.rand(9).astype(np.float32))
    a = (torch.full((5,), float("inf")), torch.zeros(5, dtype=torch.int64))
    b = (a[0].clone(), a[1].clone())
    before = am.top1_update.launches
    am.top1_update(ip, qsq, psq, *a, 4)
    am.top1_update_plain(ip, qsq, psq, *b, 4)
    assert am.top1_update.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(1024, 16384), (4097, 77), (33, 4099),
                                 (1, 1), (300, 65536)])
def test_kernel_equals_plain_on_card(B, C):
    """C % 4 == 0 takes the 16-byte loads, the others the scalar loop; a
    carried best from an earlier block exercises the strict update."""
    _need_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B + C)
    q = torch.randn(B, 32, device=dev, generator=g)
    p = torch.randn(C, 32, device=dev, generator=g)
    ip = q @ p.T
    qsq, psq = (q * q).sum(-1), (p * p).sum(-1)
    start = (torch.full((B,), float("inf"), device=dev),
             torch.zeros(B, dtype=torch.int64, device=dev))
    before = am.top1_update.launches
    k, p_ = _both(ip, qsq, psq, *start, 1 << 33)
    assert am.top1_update.launches == before + 1
    assert torch.equal(k[0], p_[0]) and torch.equal(k[1], p_[1])
    mid = (k[0] + 0.5 * (torch.arange(B, device=dev) % 3 - 1), k[1] - 7)
    k, p_ = _both(ip, qsq, psq, *mid, 5)
    assert torch.equal(k[0], p_[0]) and torch.equal(k[1], p_[1])


@pytest.mark.cuda
def test_kernel_ties_and_nan_on_card():
    """Duplicated columns: the first index wins within a row; a row holding
    a NaN score keeps its best, as the plain version's NaN minimum does."""
    _need_card()
    dev = torch.device("cuda")
    ip = torch.zeros(4, 1000, device=dev)
    ip[:, 3] = ip[:, 700] = ip[:, 999] = 1.0       # d = -2 + 0 + 0
    ip[2, 10] = float("nan")
    qsq, psq = torch.zeros(4, device=dev), torch.zeros(1000, device=dev)
    best = (torch.full((4,), float("inf"), device=dev),
            torch.full((4,), -1, dtype=torch.int64, device=dev))
    k, p = _both(ip, qsq, psq, *best, 100)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert k[1].tolist() == [103, 103, -1, 103]


@pytest.mark.cuda
def test_streaming_top1_launches_the_kernel_on_card():
    """streaming_topk_l2(k=1) on the card: one launch per block, the same
    result as the plain version carried over the blocks."""
    _need_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(513, 64, device=dev, generator=g)
    p = torch.randn(5000, 64, device=dev, generator=g)
    before = am.top1_update.launches
    d, i = td.streaming_topk_l2(q, p, 1, block=1024)
    assert am.top1_update.launches == before + 5
    psq, qsq = (p * p).sum(-1), (q * q).sum(-1)
    bd = torch.full((513,), float("inf"), device=dev)
    bi = torch.zeros(513, dtype=torch.int64, device=dev)
    for s in range(0, 5000, 1024):
        am.top1_update_plain(q @ p[s:s + 1024].T, qsq, psq[s:s + 1024], bd,
                             bi, s)
    assert torch.equal(d[:, 0], bd) and torch.equal(i[:, 0], bi)


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices_on_card():
    _need_card()
    dev = torch.device("cuda")
    ip = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError, match="q_sqnorm on cpu"):
        am.top1_update(ip, torch.zeros(4), torch.zeros(8, device=dev),
                       torch.zeros(4, device=dev),
                       torch.zeros(4, dtype=torch.int64, device=dev), 0)
