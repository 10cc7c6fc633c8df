"""Parity of the PyTorch port's ops (ivfhnsw_tpu_torch.ops) with the JAX
package's (ivfhnsw_tpu.ops) on the CPU: the same numpy inputs go through
both.

Tolerances: distances and top-k values rtol=1e-4, atol=1e-3 (the cross-
engine contract of tests/test_pallas_adc.py:42-46); integer outputs (codes,
indices on tie-free inputs) bit-equal; trained quantizers by quality, since
the two packages draw random numbers differently: the port's k-means MSE
within 5% of JAX's on the same data, and likewise the OPQ + PQ
reconstruction MSE; rotations orthogonal within 1e-5 and applied within
rtol=1e-5, atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu.ops import distances as jd
from ivfhnsw_tpu.ops import kmeans as jk
from ivfhnsw_tpu.ops import opq as jopq
from ivfhnsw_tpu.ops import pq as jpq
from ivfhnsw_tpu.ops import topk as jt
from ivfhnsw_tpu_torch.ops import distances as td
from ivfhnsw_tpu_torch.ops import kmeans as tk
from ivfhnsw_tpu_torch.ops import opq as topq
from ivfhnsw_tpu_torch.ops import pq as tpq
from ivfhnsw_tpu_torch.ops import topk as tt

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered(seed, n, d, ncl=48):
    rng = np.random.RandomState(seed)
    centers = rng.randn(ncl, d).astype(np.float32) * 5
    return (centers[rng.randint(0, ncl, n)]
            + rng.randn(n, d).astype(np.float32))


@pytest.mark.parametrize("k", [1, 10, 300])
def test_topk_smallest_matches_jax(k):
    x = np.random.RandomState(0).randn(6, 257).astype(np.float32)
    jv, ji = jt.topk_smallest(jnp.asarray(x), k)
    tv, ti = tt.topk_smallest(_t(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_smallest_pads_inf_past_n():
    tv, ti = tt.topk_smallest(_t(np.arange(5, dtype=np.float32)[None]), 8)
    assert np.isinf(tv.numpy()[0, 5:]).all()
    assert (ti.numpy()[0, 5:] == 4).all()


@pytest.mark.parametrize("n,k", [(2048, 10), (2048, 64), (1000, 10)])
def test_binned_topk_matches_jax(n, k):
    """Bin-32 path (n % 32 == 0, k <= n/32) and its flat fallback."""
    x = np.random.RandomState(1).randn(5, n).astype(np.float32)
    jv, ji = jt.binned_topk_smallest(jnp.asarray(x), k, bin_size=32)
    tv, ti = tt.binned_topk_smallest(_t(x), k, bin_size=32)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_topk_matches_jax():
    rng = np.random.RandomState(2)
    da, db = (rng.rand(4, 7).astype(np.float32) for _ in range(2))
    ia, ib = (rng.randint(0, 1000, (4, 7)).astype(np.int32)
              for _ in range(2))
    jv, ji = jt.merge_topk(*map(jnp.asarray, (da, ia, db, ib)), 7)
    tv, ti = tt.merge_topk(*map(_t, (da, ia, db, ib)), 7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_l2sqr_pairwise_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(17, 24).astype(np.float32)
    y = rng.randn(40, 24).astype(np.float32)
    ref = np.asarray(jd.l2sqr_pairwise(jnp.asarray(x), jnp.asarray(y),
                                       precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(td.l2sqr_pairwise(_t(x), _t(y)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("exact_reduce", ["topk", "binned"])
def test_streaming_topk_l2_matches_jax(exact_reduce):
    """Block (256) smaller than the point set (1000), so the running merge
    runs; ids are bit-equal on these tie-free inputs."""
    q = _clustered(4, 12, 32)
    pts = _clustered(5, 1000, 32)
    jv, ji = jd.streaming_topk_l2(jnp.asarray(q), jnp.asarray(pts), 16,
                                  block=256,
                                  precision=jax.lax.Precision.HIGHEST,
                                  exact_reduce=exact_reduce)
    tv, ti = td.streaming_topk_l2(_t(q), _t(pts), 16, block=256,
                                  exact_reduce=exact_reduce)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    d1, i1 = td.assign_top1(_t(q), _t(pts), block=256)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji)[:, 0])


def test_streaming_topk_rejects_unknown_reduce():
    with pytest.raises(ValueError):
        td.streaming_topk_l2(torch.zeros(2, 4), torch.zeros(8, 4), 2,
                             exact_reduce="approx")


@pytest.fixture(scope="module")
def pq_case():
    """Residual-like data and JAX-trained codebooks (M=8, dsub=4)."""
    x = _clustered(6, 3000, 32)
    pq = jpq.ProductQuantizer(32, 8)
    pq.train(jax.random.PRNGKey(0), x[:2000], niter=5)
    return x, np.asarray(pq.codebooks)


def test_pq_encode_decode_bit_equal(pq_case):
    x, cb = pq_case
    jcodes = np.asarray(jpq._pq_encode(jnp.asarray(x), jnp.asarray(cb)))
    tcodes = tpq._pq_encode(_t(x), _t(cb)).numpy()
    assert tcodes.dtype == np.uint8
    np.testing.assert_array_equal(tcodes, jcodes)
    jdec = np.asarray(jpq._pq_decode(jnp.asarray(jcodes), jnp.asarray(cb)))
    np.testing.assert_array_equal(tpq._pq_decode(_t(jcodes), _t(cb)).numpy(),
                                  jdec)


def test_pq_encode_in_pieces(pq_case, monkeypatch):
    """Encoding in ENCODE_ROWS pieces gives the one-shot codes."""
    x, cb = pq_case
    whole = tpq._pq_encode(_t(x), _t(cb))
    monkeypatch.setattr(tpq, "ENCODE_ROWS", 700)
    np.testing.assert_array_equal(tpq._pq_encode(_t(x), _t(cb)).numpy(),
                                  whole.numpy())


def test_pq_ip_luts_match_jax(pq_case):
    x, cb = pq_case
    q = x[:9]
    ref = np.asarray(jpq._pq_ip_luts(jnp.asarray(q), jnp.asarray(cb)))
    np.testing.assert_allclose(tpq._pq_ip_luts(_t(q), _t(cb)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)


def test_norm_quantizer_encode_decode_bit_equal():
    rng = np.random.RandomState(7)
    norms = (rng.rand(5000) * 300).astype(np.float32)
    cents = np.sort(rng.rand(256) * 300).astype(np.float32)
    jn = jpq.NormQuantizer()
    jn.centroids = jnp.asarray(cents)
    tn = tpq.NormQuantizer()
    tn.centroids = _t(cents)
    jcodes = np.asarray(jn.encode(norms))
    np.testing.assert_array_equal(tn.encode(_t(norms)).numpy(), jcodes)
    np.testing.assert_array_equal(tn.decode(_t(jcodes)).numpy(),
                                  np.asarray(jn.decode(jcodes)))


def _mse(x, cents):
    d = ((x[:, None, :] - cents[None]) ** 2).sum(-1)
    return float(d.min(1).mean())


def test_kmeans_quality_matches_jax():
    # 16 true clusters under k=64: k-means++ covers every cluster in both
    # packages whatever the draw (with 48 clusters either package misses one
    # in roughly one seed of six, which no tolerance on MSE absorbs).
    x = _clustered(8, 4000, 32, ncl=16)
    jc, _ = jk.kmeans(jax.random.PRNGKey(0), x, 64, niter=10)
    gen = torch.Generator().manual_seed(0)
    tc, tmse = tk.kmeans(gen, _t(x), 64, niter=10)
    j_mse, t_mse = _mse(x, np.asarray(jc)), _mse(x, tc.numpy())
    assert abs(t_mse - j_mse) <= 0.05 * j_mse, (t_mse, j_mse)
    assert tmse == pytest.approx(t_mse, rel=0.05)  # reported MSE is real


def test_kmeans_batched_quality_matches_jax():
    """PQ-codebook shape: 4 subspaces of dsub=4, k=64."""
    x = _clustered(9, 3000, 16).reshape(3000, 4, 4).transpose(1, 0, 2)
    x = np.ascontiguousarray(x)
    jc = np.asarray(jk.kmeans_batched(jax.random.PRNGKey(1), jnp.asarray(x),
                                      64, niter=8))
    tc = tk.kmeans_batched(torch.Generator().manual_seed(1), _t(x), 64,
                           niter=8).numpy()
    j_mse = np.mean([_mse(x[b], jc[b]) for b in range(4)])
    t_mse = np.mean([_mse(x[b], tc[b]) for b in range(4)])
    assert abs(t_mse - j_mse) <= 0.05 * j_mse, (t_mse, j_mse)


def test_kmeanspp_init_picks_data_points():
    x = _clustered(10, 500, 8)
    c = tk.kmeanspp_init(torch.Generator().manual_seed(0), _t(x), 32).numpy()
    d = ((c[:, None, :] - x[None]) ** 2).sum(-1).min(1)
    assert (d == 0).all()
    # batched form: every problem seeds from its own points
    xb = np.stack([x, x + 100.0])
    cb = tk.kmeanspp_init(torch.Generator().manual_seed(0), _t(xb), 8).numpy()
    assert (cb[1] >= 50).all() and (cb[0] < 50).all()


def test_update_with_split_matches_jax():
    rng = np.random.RandomState(11)
    sums = rng.randn(16, 4).astype(np.float32) * 10
    counts = rng.randint(0, 5, 16).astype(np.float32)
    counts[[2, 9]] = 0
    cents = rng.randn(16, 4).astype(np.float32)
    ref = np.asarray(jk._update_with_split(jnp.asarray(sums),
                                           jnp.asarray(counts),
                                           jnp.asarray(cents)))
    out = tk._update_with_split(_t(sums), _t(counts), _t(cents)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_kmeans_rejects_hierarchical_range():
    with pytest.raises(NotImplementedError):
        tk.kmeans(torch.Generator(), torch.zeros(9000, 2), 8193)


def test_apply_rotation_matches_jax():
    R = np.asarray(jopq.random_rotation(jax.random.PRNGKey(3), 32))
    x = _clustered(12, 200, 32)
    y = topq.apply_rotation(_t(x), _t(R)).numpy()
    np.testing.assert_allclose(
        y, np.asarray(jopq.apply_rotation(jnp.asarray(x), jnp.asarray(R))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        topq.apply_rotation_transpose(_t(y), _t(R)).numpy(),
        np.asarray(jopq.apply_rotation_transpose(jnp.asarray(y),
                                                 jnp.asarray(R))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        topq.apply_rotation_transpose(_t(y), _t(R)).numpy(), x, rtol=1e-5,
        atol=1e-4)


def _orthogonality_error(R):
    return float(np.abs(R @ R.T - np.eye(R.shape[0])).max())


def test_train_opq_orthogonal_and_mse_matches_jax():
    """Correlated data, where the rotation matters: the trained R is
    orthogonal and the OPQ + PQ reconstruction MSE is within 5% of the JAX
    package's."""
    rng = np.random.RandomState(13)
    x = (rng.randn(3000, 32) @ rng.randn(32, 32)).astype(np.float32)
    kw = dict(niter=10, niter_pq=4, final_pq_niter=10, ksub=16)
    jR, jpq_ = jopq.train_opq(jax.random.PRNGKey(0), x, 8, **kw)
    gen = torch.Generator().manual_seed(0)
    tR, tpq_ = topq.train_opq(gen, _t(x), 8, **kw)
    assert _orthogonality_error(tR.numpy()) < 1e-5
    assert _orthogonality_error(np.asarray(jR)) < 1e-5

    def mse(R, pq, fw):
        xr = fw(x, R)
        return float(((np.asarray(pq.decode(pq.encode(xr))) - np.asarray(xr))
                      ** 2).sum(1).mean())
    j_mse = mse(jR, jpq_, lambda a, r: jopq.apply_rotation(jnp.asarray(a), r))
    t_mse = mse(tR, tpq_, lambda a, r: topq.apply_rotation(_t(a), r))
    assert abs(t_mse - j_mse) <= 0.05 * j_mse, (t_mse, j_mse)
