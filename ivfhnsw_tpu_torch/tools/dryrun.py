"""Single-index step check and multi-shard dry run of the port: the
counterpart of ``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``.

- :func:`entry` returns the fused IVFADC search step (coarse top-k, the
  max_codes slot schedule, the ADC scan kernel, top-k) and example
  arguments on a small synthetic index.
- :func:`dryrun_multichip` builds n shards in one process (``LocalShards``
  over one device, repeated) and runs one sharded search, one sharded
  build step (data-parallel assign + encode, the centroid table
  all-gathered) and one sharded Grouping+Pruning search over them.

    python -m ivfhnsw_tpu_torch.tools.dryrun -n 8 -device cpu

``-device`` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch


def _tiny_index_arrays(nc=256, nb=8192, d=64, M=8, seed=0):
    """Deterministic synthetic index state (no training needed for a
    step check: the math runs whatever the values)."""
    rng = np.random.RandomState(seed)
    centroids = rng.randn(nc, d).astype(np.float32)
    codebooks = rng.randn(M, 256, d // M).astype(np.float32) * 0.1
    norm_centroids = np.sort(rng.rand(256).astype(np.float32) * 100)
    keys = np.sort(rng.randint(0, nc, nb).astype(np.int32))
    codes = rng.randint(0, 256, (nb, M)).astype(np.uint8)
    ids = np.arange(nb, dtype=np.int32)
    norm_codes = rng.randint(0, 256, nb).astype(np.uint8)
    offsets = np.zeros(nc + 1, np.int32)
    np.cumsum(np.bincount(keys, minlength=nc), out=offsets[1:])
    queries = rng.randn(16, d).astype(np.float32)
    return (queries, centroids, (centroids ** 2).sum(1), codebooks,
            norm_centroids, codes, ids, norm_codes, offsets)


def entry(device="cuda"):
    """(fn, example_args): the fused single-index search step
    (``ops.cuda.adc_scan.search_core`` at nprobe=8, k=10, 256-code
    slots) and its arguments on ``device``; fn(*args) -> (dists [16, 10],
    labels [16, 10])."""
    from ivfhnsw_tpu_torch.ops.cuda.adc_scan import search_core

    arrays = _tiny_index_arrays()
    nprobe, gran = 8, 256
    mx = int(np.diff(arrays[-1]).max())
    args = tuple(torch.tensor(a, device=device) for a in arrays)
    args = args[:-1] + (args[-1].long(), 2048)
    fn = functools.partial(search_core, nprobe=nprobe, k=10,
                           nslots=(2048 + mx) // gran + nprobe + 1,
                           gran=gran, coarse_block=256)
    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded search, one sharded build step and one sharded grouping
    search over ``n_devices`` shards on ``device``; raises on a wrong
    shape or a non-finite distance."""
    from ivfhnsw_tpu_torch import (IndexConfig, IVFADCGroupingIndex,
                                   IVFADCIndex, SearchParams)
    from ivfhnsw_tpu_torch.parallel import (ShardedGrouping, ShardedIVFADC,
                                            make_mesh)
    from ivfhnsw_tpu_torch.parallel.build import make_assign_encode_step

    device = torch.device(device)
    nc, nb, d, M = 8 * max(n_devices, 2), 4096, 64, 8
    (queries, centroids, _, codebooks, norm_cents, codes, ids, norm_codes,
     offsets) = _tiny_index_arrays(nc=nc, nb=nb, d=d, M=M)
    cfg = IndexConfig(d=d, nc=nc, code_size=M)
    idx = IVFADCIndex.from_numpy_state(cfg, centroids, codebooks, norm_cents,
                                       codes, ids, norm_codes, offsets,
                                       device)
    mesh = make_mesh(devices=[device] * n_devices)

    # 1. sharded search (posting lists by centroid range, queries
    #    replicated, top-k gathered and merged)
    sharded = ShardedIVFADC(idx, mesh)
    dists, _ = sharded.search(queries, SearchParams(k=10, nprobe=8,
                                                    max_codes=0))
    if dists.shape != (queries.shape[0], 10) or not np.isfinite(dists).all():
        raise AssertionError(f"sharded search: {dists.shape} distances")

    # 2. sharded build step (data-parallel assign + encode)
    step = make_assign_encode_step(mesh)
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(64 * n_devices, d).astype(np.float32),
                     device=device)
    out = step(list(x.chunk(n_devices)), [sh.centroids
                                          for sh in sharded.shards],
               idx.pq.codebooks, torch.zeros((0, 0)), idx.norm_pq.centroids)
    keys, c_out, n_out = (torch.cat([o[i] for o in out]) for i in range(3))
    if keys.shape != (x.shape[0],) or c_out.shape != (x.shape[0], M) \
            or n_out.dtype != torch.uint8:
        raise AssertionError("sharded build step: bad outputs")

    # 3. sharded grouping search (per-group state, the pruning threshold
    #    summed over the group)
    base = rng.randn(2048, d).astype(np.float32)
    gidx = IVFADCGroupingIndex(IndexConfig(d=d, nc=nc, code_size=M,
                                           nsubc=4), device)
    gidx.set_centroids(centroids)
    gidx.pq.codebooks = idx.pq.codebooks
    gidx.norm_pq.centroids = idx.norm_pq.centroids
    gidx.compute_neighbor_centroids()
    gidx.add(base)
    gidx.finalize()
    gd, _ = ShardedGrouping(gidx, mesh).search(
        queries, SearchParams(k=5, nprobe=4, max_codes=0, do_pruning=True))
    if not np.isfinite(gd[:, 0]).all():
        raise AssertionError("sharded grouping search: no finite nearest")
    print(f"dryrun_multichip({n_devices}): sharded search + build + "
          f"grouping steps OK over {n_devices} shards on {device}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=8, help="shards")
    ap.add_argument("-device", default="cuda")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass -device cpu for a CPU run")
    dryrun_multichip(a.n, a.device)
    fn, args = entry(a.device)
    d, l = fn(*args)
    print("entry():", tuple(d.shape), tuple(l.shape))


if __name__ == "__main__":
    main()
