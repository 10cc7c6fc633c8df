"""The port's build step and streamed build (ivfhnsw_tpu_torch/parallel/
build.py, pipeline.py) against the JAX package's (ivfhnsw_tpu/parallel/
build.py, pipeline.py) on the CPU, mirroring tests/test_pipeline.py and
tests/test_sharded.py::test_build_step_matches_encode_batch.

A JAX IVFADC index (d=32, nc=64, code_size 8, 3072 clustered vectors, with
and without OPQ) is trained once and carried into the port with
``from_numpy_state``. Integer outputs are held bit for bit: keys, PQ codes
and norm codes against the port's ``_encode_batch``, keys against JAX's
step; spill files and cursors byte for byte against JAX's
``StreamedIndexBuild`` given the same committed batches; stores after
resume and merge array for array. A PQ code or a norm code may differ from
JAX's step only at a near-tie between two codewords (D3 of ROADMAP.md: the
two packages' f32 matmuls round differently), which the test shows and
counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu.parallel import make_mesh as jax_mesh
from ivfhnsw_tpu.parallel import pipeline as jpipe
from ivfhnsw_tpu.parallel.build import \
    make_assign_encode_step as jax_make_step
from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.parallel import LocalShards
from ivfhnsw_tpu_torch.parallel import pipeline as tpipe
from ivfhnsw_tpu_torch.parallel.build import make_assign_encode_step

torch.set_num_threads(1)
BS = 512
_BUILT = {}


def trained(opq):
    """(JAX index, the port's index with the same quantizers, base)."""
    if opq not in _BUILT:
        rng = np.random.RandomState(3)
        nb, d = 6 * BS, 32
        centers = rng.randn(32, d).astype(np.float32) * 5
        base = (centers[rng.randint(0, 32, nb)]
                + rng.randn(nb, d).astype(np.float32))
        j = JaxIndex(JaxConfig(d=d, nc=64, code_size=8, do_opq=opq))
        key = jax.random.PRNGKey(0)
        j.train_centroids(key, base[:2000], niter=8)
        j.train_pq(key, base[:2000], opq_niter=4)
        _BUILT[opq] = j, fresh_port(j), base
    return _BUILT[opq]


def fresh_port(j):
    t = IVFADCIndex(IndexConfig(d=j.d, nc=j.nc, code_size=j.config.code_size,
                                do_opq=j.do_opq), "cpu")
    t.set_centroids(np.asarray(j.centroids))
    t.pq.codebooks = torch.from_numpy(np.array(j.pq.codebooks))
    t.norm_pq.centroids = torch.from_numpy(np.array(j.norm_pq.centroids))
    if j.do_opq:
        t.opq_R = torch.from_numpy(np.array(j.opq_R))
    return t


def fresh_jax(j):
    i2 = JaxIndex(j.config)
    i2.set_centroids(np.asarray(j.centroids))
    i2.pq, i2.norm_pq, i2.opq_R = j.pq, j.norm_pq, j.opq_R
    return i2


def store_arrays(index):
    s = index._ensure_store()
    return {k: np.asarray(getattr(s, k))
            for k in ("codes", "ids", "norm_codes", "list_offsets")}


def assert_stores_equal(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def code_ties_only(t, x, keys, codes, ref):
    """PQ codes that differ from ``ref`` lie at a near-tie: the two
    codewords are equally near (to f32 rounding) the residual's
    subvector. Returns their count."""
    rows, ms = np.nonzero(codes != ref)
    if rows.size == 0:
        return 0
    xr = torch.from_numpy(x[rows]) - t.centroids[torch.from_numpy(
        keys[rows]).long()]
    sub = t._rotate(xr).reshape(rows.size, t.pq.M, -1)[np.arange(rows.size),
                                                        ms]
    ms_t = torch.from_numpy(ms)
    da, db = (((sub - t.pq.codebooks[ms_t, torch.from_numpy(
        c[rows, ms].astype(np.int64))]) ** 2).sum(1) for c in (codes, ref))
    torch.testing.assert_close(da, db, rtol=1e-5, atol=1e-6)
    return int(rows.size)


def norm_ties_only(t, x, keys, codes, n_port, n_ref):
    """Norm codes that differ lie at a near-tie: the reconstruction's norm
    is as near (to f32 rounding) to the other code's centroid. Returns
    their count."""
    diff = n_port != n_ref
    if not diff.any():
        return 0
    c = t.centroids[torch.from_numpy(keys[diff]).long()]
    dec = t._decode(torch.from_numpy(codes[diff]))
    norms = ((dec + c) ** 2).sum(1).numpy()
    nc = t.norm_pq.centroids.numpy()
    da = np.abs(norms - nc[n_port[diff]])
    db = np.abs(norms - nc[n_ref[diff]])
    np.testing.assert_allclose(da, db, rtol=0, atol=1e-5 * norms.max())
    return int(diff.sum())


@pytest.mark.parametrize("opq", [False, True], ids=["pq", "opq"])
def test_build_step_matches_jax_and_encode_batch(opq):
    j, t, base = trained(opq)
    x = base[1000:1512]
    # JAX: the step over the 8-device mesh
    mesh = jax_mesh(8)
    cents = jax.device_put(jnp.asarray(np.asarray(j.centroids)).reshape(
        8, j.nc // 8, -1), NamedSharding(mesh, P(SHARD_AXIS)))
    R = j.opq_R if opq else jnp.zeros((0, 0), jnp.float32)
    jk, jc, jn = (np.asarray(a) for a in jax_make_step(mesh, use_opq=opq)(
        jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(SHARD_AXIS))),
        cents, j.pq.codebooks, R, j.norm_pq.centroids))
    # the port: the step over 8 local shards
    g = LocalShards(["cpu"] * 8)
    out = make_assign_encode_step(g, use_opq=opq)(
        list(torch.from_numpy(x).chunk(8)), list(t.centroids.chunk(8)),
        t.pq.codebooks, t.opq_R if opq else torch.zeros((0, 0)),
        t.norm_pq.centroids)
    keys, codes, ncodes = (torch.cat([o[i] for o in out]).numpy()
                           for i in range(3))
    assert keys.dtype == np.int32 and codes.dtype == ncodes.dtype == np.uint8
    # against the port's own single-index encoder: bit for bit
    rk = t._assign_t(torch.from_numpy(x))
    rc, rn = t._encode_batch(torch.from_numpy(x), rk)
    np.testing.assert_array_equal(keys, rk.numpy())
    np.testing.assert_array_equal(codes, rc.numpy())
    np.testing.assert_array_equal(ncodes, rn.numpy())
    # against JAX's step: keys bit for bit; a code or a norm code may
    # differ only at a near-tie (D3), and few do
    np.testing.assert_array_equal(keys, jk)
    assert code_ties_only(t, x, keys, codes, jc) <= 2
    assert norm_ties_only(t, x, keys, jc, ncodes, jn) <= 2


def test_spills_are_byte_identical_to_jax(tmp_path):
    """The same committed batches through each package's add_precomputed
    give the same four spill files and the same cursor, byte for byte."""
    j, t, base = trained(False)
    rng = np.random.RandomState(0)
    wj, wt = str(tmp_path / "j"), str(tmp_path / "t")
    bj = jpipe.StreamedIndexBuild(fresh_jax(j), jax_mesh(8), wj)
    bt = tpipe.StreamedIndexBuild(fresh_port(j), LocalShards(["cpu"] * 8),
                                  wt)
    for n in (BS, 7, BS):
        batch = (rng.randint(0, 64, n).astype(np.int32),
                 rng.randint(0, 1 << 30, n).astype(np.int32),
                 rng.randint(0, 256, (n, 8)).astype(np.uint8),
                 rng.randint(0, 256, n).astype(np.uint8))
        bj.add_precomputed(*batch)
        bt.add_precomputed(*batch)
    bj.close()
    bt.close()
    for name in tpipe.SPILLS + (tpipe.CURSOR,):
        with open(os.path.join(wj, name), "rb") as f:
            want = f.read()
        with open(os.path.join(wt, name), "rb") as f:
            assert f.read() == want, name


def test_add_batch_equals_plain_add_and_resumes_bit_identical(tmp_path):
    """Streamed add_batch over 8 local shards equals the index's own
    add_batch loop; a build stopped after 3 batches with torn bytes past
    the cursor in two spills resumes at the cursor to the same store."""
    j, _, base = trained(True)
    plain = fresh_port(j)
    for off in range(0, base.shape[0], BS):
        plain.add_batch(base[off:off + BS])
    ref = store_arrays(plain)

    g = LocalShards(["cpu"] * 8)
    a = tpipe.StreamedIndexBuild(fresh_port(j), g, str(tmp_path / "a"))
    for off in range(0, base.shape[0], BS):
        a.add_batch(base[off:off + BS])
    assert_stores_equal(ref, store_arrays(a.finalize()))

    wd = str(tmp_path / "b")
    b1 = tpipe.StreamedIndexBuild(fresh_port(j), g, wd)
    for off in range(0, 3 * BS, BS):
        b1.add_batch(base[off:off + BS])
    b1.close()
    with open(os.path.join(wd, "codes.u8"), "ab") as f:
        f.write(b"\x7f" * 123)            # a torn write past the cursor
    with open(os.path.join(wd, "keys.i32"), "ab") as f:
        f.write(b"\x01" * 9)
    b2 = tpipe.StreamedIndexBuild(fresh_port(j), g, wd)
    assert b2.processed == 3 * BS
    for off in range(b2.processed, base.shape[0], BS):
        b2.add_batch(base[off:off + BS])
    idx = b2.finalize()
    assert_stores_equal(ref, store_arrays(idx))
    assert idx.builder.ntotal == base.shape[0]   # add_batch extends it


def _spill_hosts(make, index_of, j, base, root, num_hosts=2):
    """Per-host spill dirs of precomputed batches over host_slice."""
    t = fresh_port(j)
    keys = t._assign_t(torch.from_numpy(base))
    codes, ncodes = t._encode_batch(torch.from_numpy(base), keys)
    dirs = []
    for h in range(num_hosts):
        lo, hi = tpipe.host_slice(base.shape[0], num_hosts, h)
        wd = os.path.join(root, f"host_{h:03d}")
        b = make(index_of(j), wd)
        for off in range(lo, hi, BS):
            e = min(off + BS, hi)
            b.add_precomputed(keys[off:e].numpy(),
                              np.arange(off, e, dtype=np.int32),
                              codes[off:e].numpy(), ncodes[off:e].numpy())
        b.close()
        dirs.append(wd)
    return dirs


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_merge_host_spills_matches_jax(tmp_path, writer):
    """Two hosts' spills (written by the port or by JAX) merged by each
    package give the same store, equal to one host's build of the whole
    stream."""
    j, _, base = trained(False)
    if writer == "port":
        dirs = _spill_hosts(lambda i, wd: tpipe.StreamedIndexBuild(
            i, LocalShards(["cpu"] * 4), wd), fresh_port, j, base,
            str(tmp_path))
    else:
        dirs = _spill_hosts(lambda i, wd: jpipe.StreamedIndexBuild(
            i, jax_mesh(4), wd), fresh_jax, j, base, str(tmp_path))
    got = store_arrays(tpipe.merge_host_spills(fresh_port(j), dirs))
    assert_stores_equal(store_arrays(jpipe.merge_host_spills(fresh_jax(j),
                                                             dirs)), got)
    one = _spill_hosts(lambda i, wd: tpipe.StreamedIndexBuild(
        i, LocalShards(["cpu"]), wd), fresh_port, j, base,
        str(tmp_path / "one"), num_hosts=1)
    assert_stores_equal(store_arrays(tpipe.merge_host_spills(fresh_port(j),
                                                             one)), got)


def test_merge_rejects_spills_that_disagree_with_their_cursor(tmp_path):
    j, _, base = trained(False)
    (wd,) = _spill_hosts(lambda i, wd: tpipe.StreamedIndexBuild(
        i, LocalShards(["cpu"]), wd), fresh_port, j, base[:BS],
        str(tmp_path), num_hosts=1)
    os.truncate(os.path.join(wd, "ids.i32"), 40)
    with pytest.raises(ValueError, match="inconsistent"):
        tpipe.merge_host_spills(fresh_port(j), [wd])


@pytest.mark.parametrize("total", [0, 1, 7, 1000, 1001])
@pytest.mark.parametrize("num_hosts", [1, 2, 3, 8])
def test_host_slice_matches_jax(total, num_hosts):
    got = [tpipe.host_slice(total, num_hosts, h) for h in range(num_hosts)]
    assert got == [jpipe.host_slice(total, num_hosts, h)
                   for h in range(num_hosts)]
    assert got[0][0] == 0 and got[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_initialize_distributed_is_a_noop_without_its_variables(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpipe.initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
