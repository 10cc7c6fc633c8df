"""The port's sharded search and build step under torch.distributed: two
processes on the CPU (gloo), one shard each, counterpart of
tests/test_distributed.py.

An IVFADC index (d=32, nc=64, code_size 8, 6000 clustered vectors, OPQ)
is built by the port on the CPU and written with ``save_sharded`` over a
two-shard ``LocalShards`` group into ``tmp_path``. Each worker joins a
two-rank gloo group through ``init_method="file://..."`` in ``tmp_path``
(no port), loads only its own shard (``load_sharded`` over
``DistributedShards``) and searches with both engines; the results must
equal the single index's (rtol=1e-4, atol=1e-3; labels differ only where
distances tie). Each rank also runs the build step on its half of a batch
against the gathered centroid table; keys and codes must equal the single
index's ``_encode_batch`` bit for bit. A worker also shows that a CUDA
shard is refused in a gloo group. Every join and communicate call has its
own timeout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.parallel import LocalShards, ShardedIVFADC
from ivfhnsw_tpu_torch.utils.checkpoint import save_sharded

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-3
TIMEOUT = 120
PARAMS = dict(k=10, nprobe=8, max_codes=600)

WORKER = r"""
import datetime, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from ivfhnsw_tpu_torch import SearchParams
from ivfhnsw_tpu_torch.parallel import DistributedShards
from ivfhnsw_tpu_torch.parallel.build import make_assign_encode_step
from ivfhnsw_tpu_torch.utils.checkpoint import load_sharded

root, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + root + "/init",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
try:
    try:
        DistributedShards("cuda")
        raise AssertionError("a CUDA shard was accepted by a gloo group")
    except ValueError as e:
        assert "nccl" in str(e), e
    group = DistributedShards("cpu")
    assert group.size == 2 and group.ranks == (rank,)
    sh = load_sharded(root + "/ckpt", group)
    assert [s.rank for s in sh.shards] == [rank]
    q = np.load(root + "/queries.npy")
    p = SearchParams(k=10, nprobe=8, max_codes=600)
    for engine in ("torch", "fused"):
        d, l = sh.search(q, p, engine=engine)
        np.save(f"{root}/{engine}_d{rank}.npy", d)
        np.save(f"{root}/{engine}_l{rank}.npy", l)
    x = torch.from_numpy(np.load(root + "/x.npy"))
    s0 = sh.shards[0]
    (out,) = make_assign_encode_step(group, use_opq=True)(
        [x.chunk(2)[rank]], [s0.centroids], s0.codebooks, s0.R,
        s0.norm_centroids)
    for name, t in zip(("keys", "codes", "ncodes"), out):
        np.save(f"{root}/{name}{rank}.npy", t.numpy())
finally:
    dist.destroy_process_group()
print("WORKER_OK", rank, flush=True)
"""


@pytest.fixture(scope="module")
def index():
    rng = np.random.RandomState(11)
    nb, d = 6000, 32
    centers = rng.randn(40, d).astype(np.float32) * 5
    base = (centers[rng.randint(0, 40, nb)]
            + rng.randn(nb, d).astype(np.float32))
    t = IVFADCIndex(IndexConfig(d=d, nc=64, code_size=8, do_opq=True), "cpu")
    g = torch.Generator().manual_seed(0)
    t.train_centroids(g, base[:3000], niter=8)
    t.train_pq(g, base[:3000], opq_niter=4)
    t.add_batch(base)
    t.finalize()
    queries = (centers[rng.randint(0, 40, 24)]
               + rng.randn(24, d).astype(np.float32))
    return t, queries, base[:256]


def test_two_gloo_ranks_search_and_build_as_the_single_index(index, tmp_path):
    t, queries, x = index
    root = str(tmp_path)
    save_sharded(ShardedIVFADC(t, LocalShards(["cpu", "cpu"])),
                 root + "/ckpt")
    np.save(root + "/queries.npy", queries)
    np.save(root + "/x.npy", x)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, root, str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed worker did not finish within "
                    f"{TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, f"rank {r}:\n{out}"

    t.engine = "torch"
    d1, l1 = t.search(queries, SearchParams(**PARAMS))
    t.engine = "auto"
    for engine in ("torch", "fused"):
        d0, l0 = (np.load(f"{root}/{engine}_{w}0.npy") for w in "dl")
        # both ranks hold the same merged result
        np.testing.assert_array_equal(np.load(f"{root}/{engine}_d1.npy"), d0)
        np.testing.assert_array_equal(np.load(f"{root}/{engine}_l1.npy"), l0)
        np.testing.assert_allclose(d0, d1, rtol=RTOL, atol=ATOL)
        mism = l0 != l1
        if mism.any():
            assert np.allclose(d0[mism], d1[mism], rtol=RTOL, atol=ATOL)

    xt = torch.from_numpy(x)
    keys = t._assign_t(xt)
    codes, ncodes = t._encode_batch(xt, keys)
    for name, ref in (("keys", keys.int()), ("codes", codes),
                      ("ncodes", ncodes)):
        got = np.concatenate([np.load(f"{root}/{name}{r}.npy")
                              for r in range(2)])
        np.testing.assert_array_equal(got, ref.numpy(), err_msg=name)


def _card_index(device):
    rng = np.random.RandomState(12)
    nb, d = 40000, 32
    centers = rng.randn(64, d).astype(np.float32) * 5
    base = (centers[rng.randint(0, 64, nb)]
            + rng.randn(nb, d).astype(np.float32))
    t = IVFADCIndex(IndexConfig(d=d, nc=128, code_size=8), device)
    g = torch.Generator(device=device).manual_seed(0)
    t.train_centroids(g, base[:8000], niter=8)
    t.train_pq(g, base[:8000])
    t.add_batch(base)
    t.finalize()
    return t, (centers[rng.randint(0, 64, 256)]
               + rng.randn(256, d).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,topk", [("chunk", "wide"), ("quad", "wide"),
                                         ("chunk", "twophase"),
                                         ("quad", "twophase")])
def test_local_shards_on_the_card_launch_the_kernels(layout, topk):
    """Eight shards on one card: the fused engine launches the scan
    kernels and equals the torch engine and the single index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    dev = torch.device("cuda", 0)
    t, q = _card_index(dev)
    t.scan_layout, t.scan_topk = layout, topk
    sh = ShardedIVFADC(t, LocalShards([dev] * 8))
    p = SearchParams(k=10, nprobe=16, max_codes=2000)
    tk.adc_scan_slots.launches = tk.adc_scan_slots_min.launches = 0
    d1, l1 = sh.search(q, p, engine="fused")
    assert tk.adc_scan_slots.launches >= 8
    assert (tk.adc_scan_slots_min.launches >= 8) == (topk == "twophase")
    d0, l0 = sh.search(q, p, engine="torch")
    t.engine = "torch"
    d2, l2 = t.search(q, p)
    for da, la in ((d0, l0), (d2, l2)):
        np.testing.assert_allclose(d1, da, rtol=RTOL, atol=ATOL)
        mism = la != l1
        assert np.allclose(d1[mism], da[mism], rtol=RTOL, atol=ATOL)


NCCL_WORKER = r"""
import os, sys, datetime
import numpy as np
import torch
import torch.distributed as dist
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.parallel import DistributedShards, ShardedIVFADC
from ivfhnsw_tpu_torch.utils.checkpoint import load_sharded

root = sys.argv[1]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("nccl", init_method="file://" + root + "/init",
                        world_size=1, rank=0,
                        timeout=datetime.timedelta(seconds=60))
try:
    try:
        DistributedShards("cpu")
        raise AssertionError("a CPU shard was accepted by an NCCL group")
    except ValueError as e:
        assert "gloo" in str(e), e
    sh = load_sharded(root + "/ckpt", DistributedShards(dev))
    d, l = sh.search(np.load(root + "/q.npy"),
                     SearchParams(k=10, nprobe=16, max_codes=2000))
    np.save(root + "/d.npy", d)
    np.save(root + "/l.npy", l)
finally:
    dist.destroy_process_group()
print("WORKER_OK", flush=True)
"""


@pytest.mark.cuda
def test_a_single_rank_nccl_group_searches_as_the_single_index(tmp_path):
    """One NCCL rank holding the whole index (NCCL refuses two ranks on
    one card): the collectives run and the result equals the single
    index's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    t, q = _card_index(dev)
    root = str(tmp_path)
    save_sharded(ShardedIVFADC(t, LocalShards([dev])), root + "/ckpt")
    np.save(root + "/q.npy", q)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen([sys.executable, "-c", NCCL_WORKER, root], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out = p.communicate(timeout=TIMEOUT)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
    assert p.returncode == 0 and "WORKER_OK" in out, out
    d0, l0 = t.search(q, SearchParams(k=10, nprobe=16, max_codes=2000))
    d1, l1 = np.load(root + "/d.npy"), np.load(root + "/l.npy")
    np.testing.assert_allclose(d1, d0, rtol=RTOL, atol=ATOL)
    mism = l0 != l1
    assert np.allclose(d1[mism], d0[mism], rtol=RTOL, atol=ATOL)
