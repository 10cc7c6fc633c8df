"""Streamed, resumable, multi-host-shaped index build. Counterpart of
``ivfhnsw_tpu/parallel/pipeline.py``, whose spill files and cursor it
writes byte for byte, so either package resumes or merges the other's
spills.

    host IO (any batch iterator)
      -> the sharded assign+encode step (:mod:`.build`, data parallel over
         a shard group, the centroid table all-gathered)
      -> spill of (keys, ids, codes, norm_codes) in committed batches:
         append, fsync, then replace ``cursor.json`` atomically; on reopen
         every spill is truncated back to its cursor
      -> finalize() sorts the committed spill into the index's store
         (bit-identical however many times the build was interrupted).

The reference builds a 1B-vector index with a sequential host loop
(test_ivfhnsw_sift1b.cpp:125-162); this is the resumable version of that
loop, and :func:`host_slice` / :func:`merge_host_spills` split it over
hosts.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ivfhnsw_tpu_torch.models.storage import PostingListBuilder
from ivfhnsw_tpu_torch.parallel.build import make_assign_encode_step

CURSOR = "cursor.json"
SPILLS = ("keys.i32", "ids.i32", "codes.u8", "norm_codes.u8")


class StreamedIndexBuild:
    """Resumable assign+encode over a shard group, spilling to
    ``workdir``. Every process of a distributed group passes the same
    batches; each gets the whole batch's codes back and spills them to its
    own ``workdir``.

    Usage::

        b = StreamedIndexBuild(index, group, workdir)
        for off, x in batches:          # any host IO source
            if b.processed > off:       # already committed (resume)
                continue
            b.add_batch(x)
        index = b.finalize()
    """

    def __init__(self, index, group, workdir: str):
        self.index, self.group, self.workdir = index, group, workdir
        os.makedirs(workdir, exist_ok=True)
        self.M = index.config.pq_m
        D, nc, d = group.size, index.nc, index.d
        nc_loc = -(-nc // D)
        cpad = torch.full((nc_loc * D, d), 1e30)
        cpad[:nc] = index.centroids.cpu()
        self._centroids = [cpad[s * nc_loc:(s + 1) * nc_loc].to(
            group.device(s)) for s in group.ranks]
        self._codebooks = index.pq.codebooks
        self._norm_cents = index.norm_pq.centroids
        self._R = index.opq_R if index.do_opq else torch.zeros((0, 0))
        self._step = make_assign_encode_step(group, use_opq=index.do_opq)

        # Resume: truncate spills to the last committed cursor.
        self.processed = 0
        sizes = {name: 0 for name in SPILLS}
        cur = os.path.join(workdir, CURSOR)
        if os.path.exists(cur):
            with open(cur) as f:
                state = json.load(f)
            self.processed = state["processed"]
            sizes = state["sizes"]
        self._files = {}
        for name in SPILLS:
            p = os.path.join(workdir, name)
            if not os.path.exists(p):
                open(p, "wb").close()
            want = sizes.get(name, 0)
            if os.path.getsize(p) != want:
                # partial write past the last commit: discard it
                with open(p, "r+b") as f:
                    f.truncate(want)
            self._files[name] = open(p, "ab")

    def add_batch(self, x, xids=None) -> None:
        """Assign+encode one host batch x [n, d] over the group and commit
        it; ids default to the running count."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if xids is None:
            xids = np.arange(self.processed, self.processed + n,
                             dtype=np.int32)
        D = self.group.size
        per = -(-n // D)
        xp = np.zeros((per * D, x.shape[1]), np.float32)
        xp[:n] = x
        parts = [torch.from_numpy(xp[s * per:(s + 1) * per]).to(
            self.group.device(s)) for s in self.group.ranks]
        out = self._step(parts, self._centroids, self._codebooks, self._R,
                         self._norm_cents)
        keys, codes, ncodes = (
            self.group.all_gather([o[i] for o in out], dim=0)[:n].cpu()
            .numpy() for i in range(3))
        self._commit(keys, xids, codes, ncodes)

    def add_precomputed(self, keys, xids, codes, ncodes) -> None:
        """Commit one batch whose assign+encode happened elsewhere, with
        the same write-ahead spill and atomic cursor as add_batch."""
        self._commit(keys, xids, codes, ncodes)

    def _commit(self, keys, xids, codes, ncodes) -> None:
        """Append the spills, fsync them, then replace the cursor
        atomically: a crash mid-append leaves bytes past the cursor that
        the next open truncates, so the committed prefix always records
        the first ``processed`` vectors exactly."""
        keys = np.asarray(keys, "<i4")
        for name, arr in zip(SPILLS, (keys, np.asarray(xids, "<i4"),
                                      np.asarray(codes, "u1"),
                                      np.asarray(ncodes, "u1"))):
            f = self._files[name]
            arr.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        self.processed += keys.shape[0]
        sizes = {name: self._files[name].tell() for name in SPILLS}
        tmp = os.path.join(self.workdir, CURSOR + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"processed": self.processed, "sizes": sizes}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.workdir, CURSOR))

    def close(self) -> None:
        for f in self._files.values():
            f.close()

    def finalize(self):
        """Sort the committed spill into the index's store (the order
        ``PostingListBuilder`` gives) and return the index."""
        self.close()
        return _assemble(self.index, [self.workdir], expected=self.processed)


def host_slice(total: int, num_hosts: int, host: int) -> tuple[int, int]:
    """The contiguous input range [lo, hi) of ``host``: concatenating the
    hosts' spills in host order then reproduces the order one host would
    have streamed, and the builder's stable sort keeps it within each
    list (the reference's analog is its segment-file naming,
    utils.cpp:273-275)."""
    per = -(-total // num_hosts)
    lo = min(host * per, total)
    return lo, min(lo + per, total)


def _assemble(index, workdirs, expected: int | None = None):
    parts = {name: [] for name in SPILLS}
    total = 0
    for wd in workdirs:
        with open(os.path.join(wd, CURSOR)) as f:
            state = json.load(f)
        total += state["processed"]
        for name in SPILLS:
            parts[name].append(np.fromfile(os.path.join(wd, name),
                                           np.uint8)[:state["sizes"][name]])
    keys, ids, codes, ncodes = (np.concatenate(parts[name]).view(dt)
                                for name, dt in zip(SPILLS, ("<i4", "<i4",
                                                             "u1", "u1")))
    M = index.config.pq_m
    if expected is not None and total != expected:
        raise ValueError(f"spills hold {total} vectors, expected {expected}")
    if not (keys.shape[0] == ids.shape[0] == ncodes.shape[0] == total
            and codes.shape[0] == total * M):
        raise ValueError("spill files inconsistent with cursors")
    b = PostingListBuilder(index.builder.nc, M)
    b.add(keys, ids, codes.reshape(total, M), ncodes)
    index.builder = b
    index.finalize()
    return index


def merge_host_spills(index, workdirs: list[str]):
    """One finalized index from per-host spill directories (each written
    by a ``StreamedIndexBuild`` over that host's :func:`host_slice`),
    concatenated in the given host order: bit-identical to one build that
    streamed the same vectors in the same global order, however many
    times any host's build crashed and resumed. The index's builder then
    holds the merged vectors, so add_batch + finalize extend it."""
    return _assemble(index, workdirs)


def initialize_distributed(device) -> bool:
    """Initialize torch.distributed's default process group from the
    variables of its ``env://`` contract (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK; torchrun and the other torch launchers set them,
    where the JAX package reads JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID), with NCCL for a CUDA ``device``
    and gloo for the CPU. Returns True once initialized; without the
    variables it touches nothing and returns False, and the build runs
    in one process over a ``LocalShards`` group."""
    names = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    if not all(os.environ.get(v) for v in names):
        return False
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA device needs NCCL, which this torch lacks")
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True
