"""The exact top-1 sweep of the PyTorch port through
``ivfhnsw_tpu_torch/ops/cuda/assign_min.py`` on the CPU: the plain version
(``top1_update_plain``) carried over the blocks against the composition it
replaced (``mul_`` / ``add_`` / ``add_`` / ``min`` and ``merge_topk``), the
tie rule (the first index among equal distances, an earlier block winning),
``assign_top1`` against the JAX package's on the same numpy inputs, the
wrapper's dispatch, and ``_assign_exact_t`` / ``_lloyd_pass`` against the
old composition. The kernel against the plain version on a card is in
``tests/test_torch_assign_min_kernel.py``.

Tolerances: the port's plain paths are held bit for bit (``torch.equal``),
ids equal or at exactly equal distances; against JAX, distances within
``rtol=1e-4, atol=1e-3`` and ids equal but at near-ties (the cross-engine
contract, ``tests/test_pallas_adc.py:42-46``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu.ops import distances as jd
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.models import ivfadc as tivf
from ivfhnsw_tpu_torch.ops import distances as td
from ivfhnsw_tpu_torch.ops import kmeans as tkm
from ivfhnsw_tpu_torch.ops.cuda import assign_min as am
from ivfhnsw_tpu_torch.ops.cuda import build as kbuild
from ivfhnsw_tpu_torch.ops.topk import merge_topk

RTOL, ATOL = 1e-4, 1e-3


def old_streaming_top1(queries, points, k=1, block=65536,
                       point_sqnorms=None, **_):
    """``streaming_topk_l2``'s k=1 sweep as it was before the kernel: each
    block formed in place by mul_ / add_ / add_, reduced by min and merged
    by merge_topk."""
    assert k == 1
    B, n = queries.shape[0], points.shape[0]
    block = max(128, min(block, -(-n // 128) * 128))
    if point_sqnorms is None:
        point_sqnorms = (points * points).sum(-1)
    q_sqnorm = (queries * queries).sum(-1)
    best_d = torch.full((B, 1), float("inf"))
    best_i = torch.zeros((B, 1), dtype=torch.int64)
    for s in range(0, n, block):
        dists = (queries @ points[s:s + block].T).mul_(-2.0)
        dists.add_(q_sqnorm[:, None]).add_(point_sqnorms[None, s:s + block])
        blk_d, blk_j = dists.min(dim=1, keepdim=True)
        best_d, best_i = merge_topk(best_d, best_i, blk_d, blk_j + s, 1)
    return best_d, best_i


def block_dists(queries, points, block):
    """Every distance in the blocks' own arithmetic, [B, n]."""
    psq = (points * points).sum(-1)
    qsq = (queries * queries).sum(-1)
    return torch.cat([(queries @ points[s:s + block].T).mul_(-2.0)
                      .add_(qsq[:, None]).add_(psq[None, s:s + block])
                      for s in range(0, points.shape[0], block)], dim=1)


def _data(seed, B, n, d=24):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, d).astype(np.float32))
    p = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    return q, p


def _same_or_tied(d_a, i_a, d_b, i_b, D):
    """Distances bit-equal; ids equal or at exactly the same distance in
    the blocks' arithmetic ``D``."""
    assert torch.equal(d_a, d_b)
    rows = torch.arange(D.shape[0])
    assert torch.equal(D[rows, i_a], d_a) and torch.equal(D[rows, i_b], d_b)
    moved = i_a != i_b
    assert torch.equal(D[rows, i_a][moved], D[rows, i_b][moved])


@pytest.mark.parametrize("B,n,block", [(37, 1000, 256), (50, 777, 128),
                                       (33, 300, 512), (1, 129, 128)])
def test_plain_carried_equals_old_composition(B, n, block):
    """top1_update_plain carried over the blocks (ragged last block, B not
    a multiple of 32) equals the mul_/add_/add_/min + merge_topk sweep."""
    q, p = _data(B * 1000 + n, B, n)
    psq, qsq = (p * p).sum(-1), (q * q).sum(-1)
    best_d = torch.full((B,), float("inf"))
    best_i = torch.zeros(B, dtype=torch.int64)
    for s in range(0, n, block):
        ip = q @ p[s:s + block].T
        keep = ip.clone()
        am.top1_update_plain(ip, qsq, psq[s:s + block], best_d, best_i, s)
        assert torch.equal(ip, keep)                    # ip left as it was
    d_old, i_old = old_streaming_top1(q, p, block=block)
    D = block_dists(q, p, block)
    _same_or_tied(best_d, best_i, d_old[:, 0], i_old[:, 0], D)
    d_new, i_new = td.streaming_topk_l2(q, p, 1, block=block)
    assert d_new.shape == (B, 1) and i_new.dtype == torch.int64
    assert torch.equal(d_new[:, 0], best_d) and torch.equal(i_new[:, 0],
                                                            best_i)


def _tie_points(n=400, d=8, seed=3):
    """Integer-valued points (every product and sum exact in f32, whatever
    the GEMM's order), all distinct."""
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 16, (n, d)).astype(np.float32)
    assert len({r.tobytes() for r in p}) == n
    return p


@pytest.mark.parametrize("block", [128, 256])
def test_tie_rule_first_index(block):
    """Duplicated points: within one block (5 = 20 = 21) and across a block
    edge (100 = 200 = 390) the first index wins; the distance is 0."""
    p = _tie_points()
    for a, b in ((5, 20), (5, 21), (100, 200), (100, 390)):
        p[b] = p[a]
    q = p[[20, 5, 21, 200, 390, 100]] + 0.0
    d, i = td.assign_top1(torch.from_numpy(q), torch.from_numpy(p),
                          block=block)
    assert i.tolist() == [5, 5, 5, 100, 100, 100]
    assert torch.equal(d, torch.zeros(6))


def test_tie_rule_earlier_block_wins_a_carried_best():
    """A block whose minimum equals the running best leaves it: strict
    less; a nearer one replaces it."""
    best_d = torch.tensor([2.0, 2.0, 2.0])
    best_i = torch.tensor([7, 7, 7])
    ip = torch.tensor([[0.0, 0.0], [0.5, 0.0], [-1.0, 0.0]])
    zero = torch.zeros(3)
    am.top1_update_plain(ip, zero + 2.0, torch.zeros(2), best_d, best_i, 10)
    # d = -2 ip + 2: rows [2, 2], [1, 2], [4, 2]
    assert best_d.tolist() == [2.0, 1.0, 2.0]
    assert best_i.tolist() == [7, 10, 7]


def test_offsets_past_int32():
    """Ids past 2^31 (the 1B ground truth's base-row offsets) stay int64."""
    q, p = _data(5, 9, 64)
    best_d = torch.full((9,), float("inf"))
    best_i = torch.zeros(9, dtype=torch.int64)
    off = 3 << 32
    am.top1_update(q @ p.T, (q * q).sum(-1), (p * p).sum(-1), best_d,
                   best_i, off)
    _, j = td.assign_top1(q, p)
    assert torch.equal(best_i, j + off)


def test_assign_top1_matches_jax():
    """The port's assign_top1 against the JAX package's on the same numpy
    inputs: distances within the contract, ids equal but at near-ties,
    each of which is shown."""
    rng = np.random.RandomState(11)
    q = rng.randn(300, 32).astype(np.float32)
    p = rng.randn(2000, 32).astype(np.float32)
    p[1500] = p[77]                       # an exact tie across blocks
    q[0] = p[77]
    d_t, i_t = td.assign_top1(torch.from_numpy(q), torch.from_numpy(p),
                              block=512)
    d_j, i_j = jd.assign_top1(jnp.asarray(q), jnp.asarray(p), block=512)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j).astype(np.int64)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=RTOL, atol=ATOL)
    d64 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    rows = np.flatnonzero(i_t.numpy() != i_j)
    for r in rows:
        a, b = d64[r, i_t[r]], d64[r, i_j[r]]
        print(f"near-tie row {r}: port id {int(i_t[r])} at {a!r}, JAX id "
              f"{int(i_j[r])} at {b!r}")
        assert abs(a - b) <= ATOL + RTOL * abs(b)
    assert len(rows) <= 3
    assert int(i_t[0]) == 77


def test_wrapper_cpu_never_builds(monkeypatch):
    """CPU tensors go to the plain version without touching the build; no
    launch is counted."""
    def no_build(*a, **k):
        raise AssertionError("build called for CPU tensors")
    monkeypatch.setattr(kbuild, "build", no_build)
    monkeypatch.setattr(kbuild, "build_all", no_build)
    q, p = _data(2, 40, 300)
    before = am.top1_update.launches
    d, i = td.streaming_topk_l2(q, p, 1, block=128)
    assert am.top1_update.launches == before
    d_old, i_old = old_streaming_top1(q, p, block=128)
    _same_or_tied(d[:, 0], i[:, 0], d_old[:, 0], i_old[:, 0],
                  block_dists(q, p, 128))


def test_wrapper_raises_on_other_devices_and_bad_arguments():
    meta = [torch.empty(s, device="meta", dtype=t) for s, t in (
        ((4, 8), torch.float32), ((4,), torch.float32), ((8,), torch.float32),
        ((4,), torch.float32), ((4,), torch.int64))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        am.top1_update(*meta, 0)
    ip, qs, ps = torch.zeros(4, 8), torch.zeros(4), torch.zeros(8)
    bd, bi = torch.zeros(4), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="best_i"):
        am.top1_update(ip, qs, ps, bd, bi.int(), 0)
    with pytest.raises(ValueError, match="p_sqnorm has shape"):
        am.top1_update(ip, qs, torch.zeros(7), bd, bi, 0)
    with pytest.raises(ValueError, match="ip is not contiguous"):
        am.top1_update(torch.zeros(8, 4).T, qs, ps, bd, bi, 0)


def _index(nc, d, seed):
    rng = np.random.RandomState(seed)
    idx = IVFADCIndex(IndexConfig(d=d, nc=nc, code_size=4), "cpu")
    idx.set_centroids(rng.randn(nc, d).astype(np.float32))
    return idx, torch.from_numpy(rng.randn(5000, d).astype(np.float32))


@pytest.mark.parametrize("coarse_block", [None, 128])
def test_assign_exact_same_before_and_after(monkeypatch, coarse_block):
    """_assign_exact_t gives the old composition's ids."""
    idx, x = _index(1000, 16, 5)
    idx.coarse_block = coarse_block
    new = idx._assign_exact_t(x)
    monkeypatch.setattr(tivf, "streaming_topk_l2", old_streaming_top1)
    old = idx._assign_exact_t(x)
    D = block_dists(x, idx.centroids, idx._cb())
    rows = torch.arange(len(x))
    assert torch.equal(D[rows, new], D[rows, old])
    assert int((new != old).sum()) <= 2


def test_lloyd_pass_same_before_and_after(monkeypatch):
    """ops/kmeans.py::_lloyd_pass gives the old composition's sums, counts
    and sse bit for bit."""
    idx, x = _index(700, 16, 6)
    new = tkm._lloyd_pass(x, idx.centroids, 1024, block_c=256)

    def old_assign(queries, points, block=65536, point_sqnorms=None):
        d, i = old_streaming_top1(queries, points, block=block,
                                  point_sqnorms=point_sqnorms)
        return d[:, 0], i[:, 0]
    monkeypatch.setattr(tkm, "assign_top1", old_assign)
    old = tkm._lloyd_pass(x, idx.centroids, 1024, block_c=256)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
