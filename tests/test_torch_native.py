"""The port's native helpers (ivfhnsw_tpu_torch/utils/native.py) against
the port's numpy paths (utils/io.py) and against the JAX package's
utils/native.py, byte for byte, on the CPU. The library is built with g++
at first use; the tests skip only where g++ is missing."""

import io as _io
import os
import shutil

import numpy as np
import pytest
import torch

from ivfhnsw_tpu.utils import io as jio
from ivfhnsw_tpu.utils import native as jnative
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.utils import io, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [(np.uint8, ".bvecs"), (np.float32, ".fvecs"), (np.int32, ".ivecs")]


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    assert native.available()
    return native


def test_builds_into_its_own_directory(lib):
    path = lib.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "torch_native")
    assert not path.startswith(os.path.join(REPO, "native") + os.sep)


@pytest.mark.parametrize("dtype,ext", DTYPES)
def test_xvec_read_equals_numpy_and_jax(lib, tmp_path, dtype, ext):
    rng = np.random.RandomState(3)
    path = str(tmp_path / f"x{ext}")
    io.write_xvec(path, (rng.rand(500, 24) * 200).astype(dtype))
    got = lib.xvec_read_f32(path, 24, 100, offset=37, dtype=dtype)
    want = io.read_xvec(path, 24, 100, 37, dtype=dtype).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.xvec_read_f32(path, 24, 100, offset=37, dtype=dtype))
    np.testing.assert_array_equal(io.read_xvec_fvec(path, 24),
                                  jio.read_xvec_fvec(path, 24))


def test_xvec_read_bad_dim_falls_to_numpy_which_raises(lib, tmp_path):
    path = str(tmp_path / "x.fvecs")
    io.write_xvec(path, np.ones((10, 8), np.float32))
    assert lib.xvec_read_f32(path, 16, 5, dtype=np.float32) is None
    with pytest.raises(ValueError):
        io.read_xvec_fvec(path, 16, 5)


def _series(rng, n, dtype):
    counts = rng.randint(0, 40, n).astype(np.int64)
    counts[::7] = 0
    payload = (rng.rand(int(counts.sum())) * 250).astype(dtype)
    return payload, counts


@pytest.mark.parametrize("dtype", ["u1", "<u4", "<f4"])
def test_series_writer_bytes(lib, dtype):
    payload, counts = _series(np.random.RandomState(4), 300, dtype)
    out = {}
    for name, write in (("native", io.write_len_series),
                        ("numpy", io.write_len_records),
                        ("jax", jio.write_len_series)):
        f = _io.BytesIO()
        write(f, payload, counts)
        out[name] = f.getvalue()
    assert out["native"] == out["numpy"] == out["jax"]
    assert len(out["native"]) == 4 * 300 + payload.nbytes


@pytest.mark.parametrize("dtype", ["u1", "<u4", "<f4"])
def test_series_reader_equals_numpy_and_jax(lib, dtype):
    payload, counts = _series(np.random.RandomState(5), 250, dtype)
    f = _io.BytesIO()
    f.write(b"\x01\x02\x03")              # a series from byte 3 on
    io.write_len_records(f, payload, counts)
    buf = np.frombuffer(f.getvalue(), np.uint8)
    got = io.read_len_series(buf, 3, 250, dtype)
    for want in (io.read_len_records(buf, 3, 250, dtype),
                 jnative.lenvec_series(buf, 3, 250, dtype)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == buf.size
    np.testing.assert_array_equal(got[0], payload)


def test_series_reader_truncated_raises_on_both_paths(lib):
    buf = np.frombuffer(np.asarray([1000], "<u4").tobytes() + b"xx",
                        np.uint8).copy()
    with pytest.raises(ValueError):
        io.read_len_series(buf, 0, 1, "u1")
    with pytest.raises(ValueError):
        io.read_len_records(buf, 0, 1, "u1")


def test_index_file_same_bytes_with_and_without_the_library(
        lib, tmp_path, monkeypatch):
    """An .index written and read through the native helpers has the bytes
    and arrays of the numpy path."""
    rng = np.random.RandomState(6)
    nc, d, M, nb = 40, 16, 4, 3000
    keys = rng.randint(0, nc, nb)
    idx = IVFADCIndex.from_numpy_state(
        IndexConfig(d=d, nc=nc, code_size=M),
        rng.randn(nc, d).astype(np.float32),
        rng.randn(M, 256, d // M).astype(np.float32),
        np.sort(rng.rand(256).astype(np.float32)),
        rng.randint(0, 256, (nb, M)).astype(np.uint8)[np.argsort(keys)],
        np.arange(nb, dtype=np.int32)[np.argsort(keys, kind="stable")],
        rng.randint(0, 256, nb).astype(np.uint8),
        np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=nc))]),
        torch.device("cpu"))
    idx.write(str(tmp_path / "native.index"))
    back = IVFADCIndex(idx.config, "cpu")
    back.read(str(tmp_path / "native.index"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    idx.write(str(tmp_path / "numpy.index"))
    with open(tmp_path / "native.index", "rb") as a, \
            open(tmp_path / "numpy.index", "rb") as b:
        assert a.read() == b.read()
    slow = IVFADCIndex(idx.config, "cpu")
    slow.read(str(tmp_path / "native.index"))
    for name in ("codes", "ids", "norm_codes", "list_offsets"):
        np.testing.assert_array_equal(getattr(back.store, name),
                                      getattr(slow.store, name))
        np.testing.assert_array_equal(getattr(back.store, name),
                                      getattr(idx.store, name))
