"""The port's SIFT-like corpus (ivfhnsw_tpu_torch.utils.siftlike) against
the JAX package's, on the CPU.

``SiftLikeCorpus`` is numpy in both packages: batches are held bit-equal.
``SiftLikeDeviceGen`` draws with torch where the JAX package draws with
jax.random, so its draws differ bit for bit (as D2); it is held to the
bounds of tests/test_siftlike.py:32-42 against the host corpus (zero share
within 0.05, mean norm within 3%, mean within 10%), to the uint8 grid and to
determinism per seed, on the CPU and (tests marked ``cuda``) on the card.
The JAX package is imported inside the tests that compare with it, so the
card tests run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch.utils.siftlike import (D, SiftLikeCorpus,
                                              SiftLikeDeviceGen)

N = 8192
NCLS = 4096
SIGMA = 0.75


@pytest.fixture()
def jax_siftlike():
    from ivfhnsw_tpu.utils import siftlike
    return siftlike


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n_classes,sigma,seed,batch_seed",
                         [(4096, 0.75, 0, 7), (65536, 0.75, 1, 100),
                          (512, 0.35, 3, 9999)],
                         ids=["small", "bench", "tight"])
def test_host_corpus_is_bit_equal_to_jax(jax_siftlike, n_classes, sigma,
                                         seed, batch_seed):
    a = SiftLikeCorpus(n_classes=n_classes, sigma=sigma, seed=seed)
    b = jax_siftlike.SiftLikeCorpus(n_classes=n_classes, sigma=sigma,
                                    seed=seed)
    np.testing.assert_array_equal(a._dom, b._dom)
    np.testing.assert_array_equal(a._cell_log, b._cell_log)
    x, y = a.batch(3000, seed=batch_seed), b.batch(3000, seed=batch_seed)
    assert x.dtype == np.float32 and x.shape == (3000, D)
    np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.batch(17, seed=1), b.batch(17, seed=1))


def _grid_determinism_and_statistics(device):
    gen = SiftLikeDeviceGen(device, n_classes=NCLS, sigma=SIGMA, seed=0)
    b = gen.batch_device(7, N)
    assert b.device.type == torch.device(device).type
    assert b.dtype == torch.float32 and tuple(b.shape) == (N, D)
    assert torch.equal(b, gen.batch_device(7, N))
    assert not torch.equal(b, gen.batch_device(8, N))
    b = b.cpu().numpy()
    assert b.min() >= 0.0 and b.max() <= 255.0
    assert np.array_equal(b, np.floor(b))
    a = SiftLikeCorpus(n_classes=NCLS, sigma=SIGMA, seed=0).batch(N, seed=7)
    za, zb = (a == 0).mean(), (b == 0).mean()
    assert abs(za - zb) < 0.05, (za, zb)
    na, nb = (np.linalg.norm(a, axis=1).mean(),
              np.linalg.norm(b, axis=1).mean())
    assert abs(na - nb) / na < 0.03, (na, nb)
    ma, mb = a.mean(), b.mean()
    assert abs(ma - mb) / ma < 0.10, (ma, mb)


def test_device_gen_on_the_cpu():
    _grid_determinism_and_statistics("cpu")


@pytest.mark.cuda
def test_device_gen_on_the_card(card):
    _grid_determinism_and_statistics(card)


@pytest.mark.parametrize("skew", [1.0, 3.0])
def test_device_gen_meets_the_jax_generators_bounds(jax_siftlike, skew):
    """The port's generator and the JAX one, at the same settings, within
    the same bounds of each other."""
    import jax.random as jr
    t = SiftLikeDeviceGen("cpu", n_classes=NCLS, sigma=SIGMA, seed=0,
                          skew=skew).batch_device(5, 4096).numpy()
    j = np.asarray(jax_siftlike.SiftLikeDeviceGen(
        n_classes=NCLS, sigma=SIGMA, seed=0, skew=skew).batch_device(
            jr.PRNGKey(5), 4096))
    assert abs((t == 0).mean() - (j == 0).mean()) < 0.05
    nt, nj = np.linalg.norm(t, axis=1).mean(), np.linalg.norm(j, axis=1).mean()
    assert abs(nt - nj) / nj < 0.03
    assert abs(t.mean() - j.mean()) / j.mean() < 0.10


def test_skew_concentrates_on_low_classes():
    """skew > 1 draws low class ids more often: the same tables, a
    different class mix, so the batch differs from the uniform one."""
    u = SiftLikeDeviceGen("cpu", n_classes=256, seed=0)
    s = SiftLikeDeviceGen("cpu", n_classes=256, seed=0, skew=4.0)
    assert torch.equal(u._state["cell_log"], s._state["cell_log"])
    assert not torch.equal(u.batch_device(1, 512), s.batch_device(1, 512))


def _release(device):
    gen = SiftLikeDeviceGen(device, n_classes=256, sigma=SIGMA, seed=0)
    gen.batch_device(0, 64)
    gen.release()
    assert gen._state["dom"] is None and gen._state["cell_log"] is None
    with pytest.raises(RuntimeError):
        gen.batch_device(0, 64)


def test_release_frees_the_tables_on_the_cpu():
    _release("cpu")


@pytest.mark.cuda
def test_release_frees_the_tables_on_the_card(card):
    _release(card)
