"""Shared driver pipeline. Counterpart of ``ivfhnsw_tpu/drivers/common.py``.

The reference drivers' stage structure (e.g. tests/test_ivfhnsw_sift1b.cpp):

    Parser -> load queries + gt -> build quantizer -> train PQ
    -> assign base vectors -> add loop -> timed search loop
    -> Recall@k + us/query

The port drives it on the synthetic corpus; the file-backed datasets and
the exists()-gated artifact files (.fvecs centroids, faiss .pq, .ivecs
assignments, .index) wait for the file formats to be ported, and the
driver refuses their path flags.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

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


def check_supported(cfg: RunConfig) -> None:
    """Refuse the file-backed flags whose formats are not ported yet."""
    paths = [f.name for f in dataclasses.fields(cfg)
             if f.name.startswith("path_") and getattr(cfg, f.name)]
    if paths:
        raise NotImplementedError(
            f"file-backed runs are not ported yet (got {', '.join(paths)}); "
            "use -synthetic SEED")


def setup_quantizer(index, cfg: RunConfig, ds,
                    generator: torch.Generator) -> None:
    """Train the coarse centroids on the device."""
    w = StopW()
    log(f"training {cfg.index.nc} centroids on {index.device} ...")
    nsub = min(ds.learn.shape[0], max(cfg.index.nc * 32, 100_000))
    index.train_centroids(generator, ds.learn[:nsub], niter=15)
    _sync(index.device)
    log(f"centroids trained in {w.elapsed_s():.1f}s")


def setup_pq(index, cfg: RunConfig, ds, generator: torch.Generator) -> None:
    """Train the PQ and norm-PQ on a random subset of the learn set
    (test_ivfhnsw_sift1b.cpp:54-90)."""
    w = StopW()
    nsubt = min(cfg.nsubt or 65536, ds.learn.shape[0])
    sub = io.random_subset(ds.learn, nsubt)
    log(f"training PQ on {nsubt} vectors ...")
    index.train_pq(generator, sub)
    _sync(index.device)
    log(f"PQ trained in {w.elapsed_s():.1f}s")


def load_or_assign(index, cfg: RunConfig, ds) -> np.ndarray:
    """Coarse assignments of every base vector, in the reference's 1M-vector
    batches (test_ivfhnsw_sift1b.cpp:95-120)."""
    w = StopW()
    log("assigning base vectors to centroids ...")
    chunks = []
    done = 0
    for _, batch in io.prefetch(ds.base_batches()):
        chunks.append(index.assign(batch))
        done += batch.shape[0]
        log(f"  assigned {done}/{ds.total_base} [{w.elapsed_s():.1f}s]")
    return np.concatenate(chunks)


def build_or_read_index(index, cfg: RunConfig, ds, idxs,
                        grouping: bool = False) -> dict:
    """Add loop + finalize (test_ivfhnsw_sift1b.cpp:125-162). The grouping
    construction (test_ivfhnsw_grouping_sift1b.cpp:136-200) first sweeps
    the neighbour centroids and streams the alpha pass over the base set;
    after finalize it recomputes the inter-centroid distances directly,
    and search uses those. Returns the seconds of each stage ("alpha_pass"
    with grouping, "add", "finalize"), the device synced at each end."""
    stages = {}
    w = StopW()
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
        log(f"  added {off + n}/{ds.total_base} [{w.elapsed_s():.1f}s]")
    _sync(index.device)
    stages["add"] = w.elapsed_s() - sum(stages.values())
    index.finalize()
    if grouping:
        index.compute_inter_centroid_dists()
    _sync(index.device)
    stages["finalize"] = w.elapsed_s() - sum(stages.values())
    log(f"index built in {w.elapsed_s():.1f}s")
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


def synthetic_setup(cfg: RunConfig, extras: dict):
    """What every synthetic-corpus driver checks and makes first: refuse
    the unported file-backed flags, resolve ``-device`` (a CUDA device
    without a card is an error, never a fall-back to the CPU; ``-device
    cpu`` runs the kernels' plain versions), and draw the corpus of seed
    ``-synthetic``. Returns (device, dataset)."""
    if "synthetic" not in extras:
        raise NotImplementedError("file-backed runs are not ported yet; "
                                  "pass -synthetic SEED")
    check_supported(cfg)
    device = torch.device(extras["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {extras['device']}: no CUDA device is "
                           "available; pass -device cpu to run on the CPU")
    return device, SyntheticDataset(cfg, int(extras["synthetic"]), device)
