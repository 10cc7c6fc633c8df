"""Shared driver pipeline. Counterpart of ``ivfhnsw_tpu/drivers/common.py``.

The reference drivers' stage structure (e.g. tests/test_ivfhnsw_sift1b.cpp):

    Parser -> load gt -> load queries -> build quantizer
    -> [PQ files exist? load : train + save]
    -> [precomputed idxs exist? load : assign in 1M batches + save (.ivecs)]
    -> [index exists? read : add loop + write]
    -> set search params -> timed search loop -> Recall@k + us/query

Every expensive stage is exists()-gated, so a rerun resumes from the
artifacts of the run before it, as the reference does
(test_ivfhnsw_sift1b.cpp:54,95,125). Every artifact (.fvecs centroids, faiss
.pq / .norm_pq / .opq, .ivecs assignments in 1M-vector records, .index) has
the bytes the JAX package and the reference write, so each reads the
others' files.

Datasets are file-backed (``FileDataset``: a .bvecs or .fvecs base by its
extension, which is all that separates the SIFT1B drivers from the DEEP1B
ones) or synthetic (``SyntheticDataset``: a deterministic clustered corpus
with exact ground truth computed on the device).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

# Importing ops.distances pins float32 matmuls to full precision (TF32
# off), which exact_nn's ground truth depends on.
from ivfhnsw_tpu_torch.ops import distances as _distances  # noqa: F401
from ivfhnsw_tpu_torch.utils import io
from ivfhnsw_tpu_torch.utils.config import RunConfig, parse_args
from ivfhnsw_tpu_torch.utils.recall import recall_at_k
from ivfhnsw_tpu_torch.utils.timer import StopW

ASSIGN_BATCH = 1_000_000  # reference batch size (test_ivfhnsw_sift1b.cpp:102)
GT_BASE_BLOCK = 262_144   # base rows per ground-truth sweep step
GT_QUERY_BLOCK = 1024
DEFAULT_DEVICE = "cuda"   # -device when the command line names none


def log(msg: str) -> None:
    print(msg, flush=True)


def have_file(path: str) -> bool:
    """The gate of every cached stage: a path was given and its file
    exists."""
    return bool(path) and os.path.exists(path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SyntheticDataset:
    """Deterministic clustered corpus, the same draw as the JAX package's
    SyntheticDataset for the same seed, with exact ground truth computed by
    brute force on ``device``."""

    def __init__(self, cfg: RunConfig, seed: int, device):
        rng = np.random.RandomState(seed)
        d = cfg.index.d
        self.device = torch.device(device)
        self.nb = cfg.nb or 200_000
        self.nt = cfg.nt or max(self.nb // 10, 10_000)
        self.nq = cfg.nq or 1000
        n_clusters = max(64, cfg.index.nc)
        centers = rng.randn(n_clusters, d).astype(np.float32) * 4.0
        scales = 0.5 + rng.rand(n_clusters, 1).astype(np.float32)

        def draw(n):
            a = rng.randint(0, n_clusters, n)
            return centers[a] + rng.randn(n, d).astype(np.float32) * scales[a]

        self.base = draw(self.nb)
        self.learn = draw(self.nt)
        self.queries = draw(self.nq)
        self._gt = None
        self.ngt = 1

    @property
    def gt(self) -> np.ndarray:
        """[nq, 1] int64 exact nearest base vector of each query."""
        if self._gt is None:
            self._gt = exact_nn(self.queries, self.base, self.device)
        return self._gt

    def base_batches(self, batch: int = ASSIGN_BATCH):
        for off in range(0, self.nb, batch):
            yield off, self.base[off:off + batch]

    @property
    def total_base(self) -> int:
        return self.nb


def exact_nn(queries: np.ndarray, base: np.ndarray, device) -> np.ndarray:
    """Brute-force nearest neighbour (squared L2, f32) of each query over
    ``base`` on ``device``, streaming base blocks. Returns [nq, 1] int64."""
    device = torch.device(device)
    q_all = torch.tensor(np.asarray(queries, np.float32), device=device)
    best_d = torch.full((q_all.shape[0],), float("inf"), device=device)
    best_i = torch.zeros(q_all.shape[0], dtype=torch.int64, device=device)
    for s in range(0, base.shape[0], GT_BASE_BLOCK):
        blk = torch.tensor(np.asarray(base[s:s + GT_BASE_BLOCK], np.float32),
                           device=device)
        bsq = (blk * blk).sum(dim=1)
        for qs in range(0, q_all.shape[0], GT_QUERY_BLOCK):
            q = q_all[qs:qs + GT_QUERY_BLOCK]
            dist = bsq[None, :] - 2.0 * (q @ blk.T)   # + ||q||^2 (const)
            d, i = dist.min(dim=1)
            better = d < best_d[qs:qs + GT_QUERY_BLOCK]
            best_d[qs:qs + GT_QUERY_BLOCK] = torch.where(
                better, d, best_d[qs:qs + GT_QUERY_BLOCK])
            best_i[qs:qs + GT_QUERY_BLOCK] = torch.where(
                better, i + s, best_i[qs:qs + GT_QUERY_BLOCK])
    return best_i.cpu().numpy()[:, None]


class FileDataset:
    """File-backed dataset per the reference's path conventions: queries
    and ground truth read at once, the learn set on first use, the base
    streamed in batches from its .bvecs / .fvecs file. A count that the
    command line leaves at 0 (-nq, -nt, -nb) means the whole file."""

    def __init__(self, cfg: RunConfig):
        d = cfg.index.d
        self.nb = cfg.nb
        self.nt = cfg.nt
        self.ngt = cfg.ngt
        self._cfg = cfg
        self._d = d
        self.queries = io.read_xvec_fvec(cfg.path_q, d, cfg.nq or None)
        self.nq = self.queries.shape[0]
        self.gt = io.read_xvec(cfg.path_gt, cfg.ngt, self.nq,
                               dtype=np.int32).astype(np.int64)
        self._learn = None

    @property
    def learn(self) -> np.ndarray:
        if self._learn is None:
            self._learn = io.read_xvec_fvec(self._cfg.path_learn, self._d,
                                            self._cfg.nt or None)
        return self._learn

    def base_batches(self, batch: int = ASSIGN_BATCH):
        total = self.total_base
        for off in range(0, total, batch):
            n = min(batch, total - off)
            yield off, io.read_xvec_fvec(self._cfg.path_base, self._d, n,
                                         off)

    @property
    def total_base(self) -> int:
        """Base-vector count: ``nb``, or from the file size (no decode
        sweep)."""
        cfg = self._cfg
        return cfg.nb or io.xvec_count(
            cfg.path_base, self._d,
            io.XVEC_DTYPES[os.path.splitext(cfg.path_base)[1]])


def get_dataset(cfg: RunConfig, synthetic_seed: int | None, device):
    """The synthetic corpus of ``synthetic_seed`` (seed 0 when no
    ``-path_base`` names a file either), else the file-backed dataset."""
    if synthetic_seed is not None or not cfg.path_base:
        return SyntheticDataset(cfg, synthetic_seed or 0, device)
    return FileDataset(cfg)


def setup_quantizer(index, cfg: RunConfig, ds,
                    generator: torch.Generator) -> str:
    """Coarse centroids: loaded from ``path_centroids`` when the file exists
    (the reference's external k-means input), else trained on the device
    and saved there as .fvecs. Returns "loaded" or "trained"."""
    path = cfg.path_centroids
    if have_file(path):
        log(f"loading centroids from {path}")
        index.load_centroids(path)
        return "loaded"
    w = StopW()
    log(f"training {cfg.index.nc} centroids on {index.device} ...")
    nsub = min(ds.learn.shape[0], max(cfg.index.nc * 32, 100_000))
    index.train_centroids(generator, ds.learn[:nsub], niter=15)
    _sync(index.device)
    log(f"centroids trained in {w.elapsed_s():.1f}s")
    if path:
        io.write_xvec(path, index.centroids.cpu().numpy())
    return "trained"


def setup_pq(index, cfg: RunConfig, ds, generator: torch.Generator) -> str:
    """PQ, norm PQ and (with ``do_opq``) the OPQ rotation: loaded when all
    their files exist, else trained on a random subset of the learn set and
    saved (test_ivfhnsw_sift1b.cpp:54-90). Returns "loaded" or "trained"."""
    p_pq, p_norm, p_opq = cfg.path_pq, cfg.path_norm_pq, cfg.path_opq_matrix
    if (have_file(p_pq) and have_file(p_norm)
            and (not cfg.index.do_opq or have_file(p_opq))):
        log(f"loading PQ from {p_pq}")
        index.load_quantizers(p_pq, p_norm, p_opq)
        return "loaded"
    w = StopW()
    nsubt = min(cfg.nsubt or 65536, ds.learn.shape[0])
    sub = io.random_subset(ds.learn, nsubt)
    log(f"training PQ on {nsubt} vectors (do_opq={cfg.index.do_opq}) ...")
    index.train_pq(generator, sub)
    _sync(index.device)
    log(f"PQ trained in {w.elapsed_s():.1f}s")
    if p_pq and p_norm:
        index.save_quantizers(p_pq, p_norm, p_opq)
    return "trained"


def write_assignments(path: str, idxs: np.ndarray) -> None:
    """Coarse assignments in the reference's .ivecs batch format: records
    [u32 n | n x u32] of ASSIGN_BATCH entries (the last one shorter)."""
    with open(path, "wb") as f:
        for off in range(0, idxs.shape[0], ASSIGN_BATCH):
            blk = idxs[off:off + ASSIGN_BATCH].astype("<u4")
            np.asarray([blk.size], "<u4").tofile(f)
            blk.tofile(f)


def read_assignments(path: str) -> np.ndarray:
    """Every record [u32 n | n x u32] of an assignment file, concatenated,
    as int32."""
    chunks = []
    with open(path, "rb") as f:
        while True:
            hdr = np.fromfile(f, "<u4", 1)
            if hdr.size == 0:
                break
            blk = np.fromfile(f, "<u4", int(hdr[0]))
            if blk.size != int(hdr[0]):
                raise ValueError(f"{path}: a record of {int(hdr[0])} entries "
                                 f"ends after {blk.size}")
            chunks.append(blk)
    if not chunks:
        return np.zeros(0, np.int32)
    return np.concatenate(chunks).astype(np.int32)


def load_or_assign(index, cfg: RunConfig, ds) -> np.ndarray:
    """Coarse assignments of every base vector: read from
    ``path_precomputed_idxs`` when the file exists, else computed in the
    reference's 1M-vector batches (test_ivfhnsw_sift1b.cpp:95-120) and
    written there."""
    path = cfg.path_precomputed_idxs
    total = ds.total_base
    if have_file(path):
        log(f"loading precomputed idxs from {path}")
        idxs = read_assignments(path)[:total]
        if idxs.shape[0] < total:
            raise ValueError(f"{path}: {idxs.shape[0]} assignments for "
                             f"{total} base vectors")
        return idxs
    w = StopW()
    log("assigning base vectors to centroids ...")
    chunks = []
    done = 0
    for _, batch in io.prefetch(ds.base_batches()):
        chunks.append(index.assign(batch))
        done += batch.shape[0]
        log(f"  assigned {done}/{total} [{w.elapsed_s():.1f}s]")
    idxs = np.concatenate(chunks)
    if path:
        write_assignments(path, idxs)
    return idxs


def build_or_read_index(index, cfg: RunConfig, ds, idxs,
                        grouping: bool = False) -> dict:
    """The index: read from ``path_index`` when the file exists, else the
    add loop + finalize (test_ivfhnsw_sift1b.cpp:125-162) and a write
    there. The grouping construction
    (test_ivfhnsw_grouping_sift1b.cpp:136-200) first sweeps the neighbour
    centroids and streams the alpha pass over the base set; after finalize
    it recomputes the inter-centroid distances directly, and search uses
    those. Returns the seconds of each stage, the device synced at each
    end: {"read"} for a read, else "alpha_pass" (with grouping), "add",
    "finalize" and, with a path, "write"."""
    path = cfg.path_index
    w = StopW()
    if have_file(path):
        log(f"reading index from {path}")
        index.read(path)
        _sync(index.device)
        return {"read": w.elapsed_s()}
    stages = {}
    total = ds.total_base
    if grouping:
        index.compute_neighbor_centroids()
        log("alpha pass ...")
        for off, batch in io.prefetch(ds.base_batches()):
            index.alpha_pass(batch, idxs[off:off + batch.shape[0]])
        index.finalize_alphas()
        _sync(index.device)
        stages["alpha_pass"] = w.elapsed_s()
        log(f"alphas learned in {stages['alpha_pass']:.1f}s")
    log("adding base vectors ...")
    for off, batch in io.prefetch(ds.base_batches()):
        n = batch.shape[0]
        index.add_batch(batch, np.arange(off, off + n, dtype=np.int32),
                        idxs[off:off + n] if idxs is not None else None)
        log(f"  added {off + n}/{total} [{w.elapsed_s():.1f}s]")
    _sync(index.device)
    stages["add"] = w.elapsed_s() - sum(stages.values())
    index.finalize()
    if grouping:
        index.compute_inter_centroid_dists()
    _sync(index.device)
    stages["finalize"] = w.elapsed_s() - sum(stages.values())
    log(f"index built in {w.elapsed_s():.1f}s")
    if path:
        index.write(path)
        stages["write"] = w.elapsed_s() - sum(stages.values())
    return stages


def eval_search(index, cfg: RunConfig, ds, search_fn=None) -> dict:
    """Timed query loop + Recall@k in the reference's output format
    (test_ivfhnsw_sift1b.cpp:188-215). The search returns host arrays, so
    the clock stops after the device finished."""
    p = cfg.search
    params = dataclasses.replace(p)
    fn = search_fn or (lambda q: index.search(q, params))
    fn(ds.queries[:min(256, ds.nq)])  # warm-up (kernel build and load)
    w = StopW()
    dists, labels = fn(ds.queries)
    dt_us = w.getElapsedTimeMicro()
    recalls = recall_at_k(labels, ds.gt, ks=(1, min(p.k, 10), p.k))
    for k, r in sorted(recalls.items()):
        log(f"Recall@{k}: {r:.4f}")
    log(f"Time per query: {dt_us / ds.nq:.1f} us")
    return {"recalls": recalls, "us_per_query": dt_us / ds.nq,
            "dists": dists, "labels": labels}


def parse_driver_args(extra_flags=(), argv=None):
    """Reference CLI grammar + driver-local flags (e.g. -synthetic SEED,
    -device DEV). ``-device`` defaults to ``cuda``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extras = {"device": DEFAULT_DEVICE} if "device" in extra_flags else {}
    for flag in extra_flags:
        if f"-{flag}" in argv:
            i = argv.index(f"-{flag}")
            extras[flag] = argv[i + 1]
            del argv[i:i + 2]
    return parse_args(argv), extras


def resolve_device(extras: dict) -> torch.device:
    """The ``-device`` of a driver's command line. A CUDA device without a
    card is an error, never a fall-back to the CPU; ``-device cpu`` runs
    the kernels' plain versions."""
    device = torch.device(extras["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {extras['device']}: no CUDA device is "
                           "available; pass -device cpu to run on the CPU")
    return device


def build_pipeline(index, cfg: RunConfig, ds, grouping: bool = False,
                   before_index=None) -> dict:
    """The build stages of the eval drivers on ``index``, each loaded from
    its file or computed (and then saved): centroids, [neighbour
    centroids,] quantizers, assignments, the index. ``before_index``, when
    given, is called with the assignments before the index is read or
    built. Returns the stage record {"how": {"centroids", "pq": "loaded" |
    "trained", "assign": "loaded" | "computed", "index": "read" |
    "built"}, "seconds": {stage: host seconds, the device synced at each
    end}, "assignments": the coarse ids [nb] int32}."""
    gen = torch.Generator(device=index.device).manual_seed(0)
    how, seconds = {}, {}

    def stage(name, fn):
        w = StopW()
        out = fn()
        _sync(index.device)
        seconds[name] = w.elapsed_s()
        return out

    how["centroids"] = stage("centroids",
                             lambda: setup_quantizer(index, cfg, ds, gen))
    if grouping:
        stage("neighbors", index.compute_neighbor_centroids)
    how["pq"] = stage("pq", lambda: setup_pq(index, cfg, ds, gen))
    how["assign"] = ("loaded" if have_file(cfg.path_precomputed_idxs)
                     else "computed")
    idxs = stage("assign", lambda: load_or_assign(index, cfg, ds))
    if before_index is not None:
        before_index(idxs)
    built = build_or_read_index(index, cfg, ds, idxs, grouping=grouping)
    how["index"] = "read" if "read" in built else "built"
    seconds.update(built)
    return {"how": how, "seconds": seconds, "assignments": idxs}


def driver_setup(cfg: RunConfig, extras: dict):
    """What every driver makes first: the device (:func:`resolve_device`)
    and the dataset (:func:`get_dataset`, ``-synthetic SEED`` or the
    ``-path_*`` files). Returns (device, dataset)."""
    device = resolve_device(extras)
    seed = int(extras["synthetic"]) if "synthetic" in extras else None
    return device, get_dataset(cfg, seed, device)
