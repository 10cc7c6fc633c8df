"""The port's scale3 recipe (ivfhnsw_tpu_torch/tools/scale3.py) against
bench.py's, on the CPU: the numpy draws of the corpus (supers, spectrum,
mix) bit for bit, the device draws reproducible per seed, and the in-stream
top-1 ground truth against a float64 numpy brute force (ties aside).

bench.py imports JAX inside make_scale3_gen; the arrays it hands to
``jnp.asarray`` are recorded there, with its S3_NC set to the point under
test so that its mids stay small."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ivfhnsw_tpu_torch.tools import scale3

torch.set_num_threads(1)


@pytest.mark.parametrize("nc", [1024, 8192])   # 256 supers; the 2048 cap
def test_corpus_numpy_draws_equal_bench(nc, monkeypatch):
    seen = []
    asarray = jnp.asarray

    def record(x, *a, **kw):
        out = asarray(x, *a, **kw)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(bench, "S3_NC", nc)
    monkeypatch.setattr(jnp, "asarray", record)
    bench.make_scale3_gen()
    supers, spectrum, mix = seen[:3]
    c = scale3.scale3_corpus(torch.device("cpu"), nc)
    assert supers.shape == (min(2048, nc // 4), scale3.D)
    for got, want in ((c.supers, supers), (c.spectrum, spectrum),
                      (c.mix, mix)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # the mids: nc / n_sup around each super, N(0, 1.5^2) off it
    off = c.mids - torch.repeat_interleave(c.supers, nc // len(supers), 0)
    assert c.mids.shape == (nc, scale3.D)
    assert abs(float(off.std()) - 1.5) < 0.05


def test_gen_is_the_same_tensor_for_a_seed():
    c = scale3.scale3_corpus(torch.device("cpu"), 1024)
    a = c.gen(scale3.SEED_BASE, 4096)
    assert a.shape == (4096, scale3.D) and a.dtype == torch.float32
    assert torch.equal(a, c.gen(scale3.SEED_BASE, 4096))
    assert torch.equal(a, scale3.scale3_corpus(
        torch.device("cpu"), 1024).gen(scale3.SEED_BASE, 4096))
    assert not torch.equal(a, c.gen(scale3.SEED_BASE + 1, 4096))
    assert torch.isfinite(a).all()


def test_top_one_over_batches_equals_brute_force():
    c = scale3.scale3_corpus(torch.device("cpu"), 1024)
    q = c.gen(scale3.QUERY_SEED, 96)
    top = scale3.TopOne(q)
    blocks = []
    for bi in range(4):
        blk = c.gen(scale3.SEED_BASE + bi, 3000)
        top.merge(blk, bi * 3000)
        blocks.append(blk.numpy().astype(np.float64))
    base = np.concatenate(blocks)
    qd = q.numpy().astype(np.float64)
    dist = ((qd[:, None, :] - base[None]) ** 2).sum(-1)
    want = dist.argmin(1)
    got = top.labels.numpy()[:, 0]
    assert top.labels.shape == (96, 1) and top.labels.dtype == torch.int64
    np.testing.assert_allclose(top.dists.numpy()[:, 0], dist.min(1),
                               rtol=1e-4, atol=1e-2)
    diff = got != want
    # a label may differ only where the two rows tie in f32
    rows = np.arange(96)[diff]
    np.testing.assert_allclose(dist[rows, got[diff]], dist[rows, want[diff]],
                               rtol=1e-5, atol=1e-3)
    assert diff.sum() <= 2
