"""Routed-against-exact assignment A/B on SIFT statistics: the counterpart
of the JAX rig ``tools/assign_ab.py``.

The routed two-level assigner (``ops/hierarchical.py::TwoLevelAssigner``)
agrees with exact assignment on clustered Gaussian corpora but not on SIFT
statistics, where the streamed builders' MATCH_GATE falls back to exact
assignment. This tool measures what routed assignment would cost in recall
if the gate did not exist: three index twins over one SIFT-like stream
with grouping_scale's cached centroids (``<cache>/grouping_scale/
centroids.npy``: nc=2^17 at the bench tool's sizes) and one shared residual
PQ + norm PQ (trained once on 262,144 rows under exact assignment, cached
as ``grouping_scale/ab.pq`` / ``ab.norm_pq``), which differ only in how
their rows are assigned:

- ``exact``: ``IVFADCIndex._assign_device_exact``;
- ``routed_w4`` / ``routed_w16``: ``TwoLevelAssigner`` with n_super =
  min(2048, nc // 4) and w = 4 / 16, one super k-means (generator seed
  295) shared by both.

Each batch of 2^20 rows (``SiftLikeDeviceGen(n_classes=S3SL_NCLS, sigma,
seed=13, skew)``, batch i drawn from seed 4,000,000 + i) is assigned the
three ways (host clock per assigner), encoded into each twin with the
shared quantizers and merged into the exact top-1 ground truth of the
held-out queries (seed 777,777, grouping_scale's); a routed twin's share
of rows assigned as exact assigns them is its drift series. Each twin is
then finalized and searched at k=100, nprobe 128, max_codes 100k under
the profiled scan budget (its largest ``scan_slot_demand``), 256 queries a
batch after one warm batch. The record keeps the JAX rig's keys (R@1/10/
100, ``assign_seconds``, ``search_seconds_unpipelined``, ``list_size_max``,
``list_size_p99``, ``empty_lists``, ``mean_match_rate``,
``drift_min_match_rate``, ``drift_series``), unrounded, and is written to
``<cache>/assign_ab.json`` only (``.bench_cache_torch/bench[_smoke]/`` or
``BENCH_CACHE_DIR``), never beside the committed records; one JSON line
without the drift series goes to stdout, progress to stderr.

    python -m ivfhnsw_tpu_torch.tools.assign_ab [--nb 16777216]
        [--nprobe 128] [--max-codes 100000] [--device cuda] [--smoke]

Reference: assignment is exact by construction in the reference
(IndexIVF_HNSW.cpp:68-72).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.ops.hierarchical import TwoLevelAssigner
from ivfhnsw_tpu_torch.tools import bench, scale3
from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams
from ivfhnsw_tpu_torch.utils.recall import recall_at_k
from ivfhnsw_tpu_torch.utils.siftlike import SiftLikeDeviceGen

ROUTED_W = {"routed_w4": 4, "routed_w16": 16}
VARIANTS = ("exact", *ROUTED_W)
BATCH = 1_048_576          # rows per stream batch
PQ_ROWS = 262_144          # rows of the shared PQ's training
SEEDS = dict(corpus=13, queries=777_777, learn=777_003, base=4_000_000,
             router=295)
SEARCH_BATCH = 256
CORPUS = "siftlike (grouping_scale centroids, seed 13)"


def n_super_for(nc: int) -> int:
    """The routers' super count (the JAX rig's rule)."""
    return min(2048, nc // 4)


def shared_quantizers(proto: IVFADCIndex, gen, nb: int, sd: str) -> None:
    """proto's PQ + norm PQ: loaded from ``sd/ab.pq`` / ``ab.norm_pq``, or
    trained (exact assignment, generator seed 0) on the first min(262,144,
    nb) rows of seed 777,003 and saved there."""
    p_pq, p_npq = os.path.join(sd, "ab.pq"), os.path.join(sd, "ab.norm_pq")
    if os.path.exists(p_pq) and os.path.exists(p_npq):
        proto.load_quantizers(p_pq, p_npq)
        return
    learn = gen.batch_device(SEEDS["learn"], min(PQ_ROWS, nb))
    bench.log("assign_ab: training the shared PQ ...")
    proto.train_pq(torch.Generator(device=proto.device).manual_seed(0),
                   learn)
    proto.save_quantizers(p_pq, p_npq)


def twins(proto: IVFADCIndex) -> dict:
    """One empty index per variant, each with proto's centroids and its
    quantizer objects."""
    out = {}
    for v in VARIANTS:
        ix = IVFADCIndex(proto.config, proto.device)
        ix.set_centroids(proto.centroids)
        ix.pq, ix.norm_pq = proto.pq, proto.norm_pq
        out[v] = ix
    return out


def routers(centroids: torch.Tensor) -> dict:
    """The routed variants' assigners over ``centroids``: one super
    k-means (seed 295) at n_super_for(nc), at w = 4 and 16."""
    first, *rest = ROUTED_W.items()
    r0 = TwoLevelAssigner(centroids, n_super=n_super_for(centroids.shape[0]),
                          w=first[1], generator=torch.Generator(
                              device=centroids.device).manual_seed(
                                  SEEDS["router"]))
    out = {first[0]: r0}
    for v, w in rest:
        out[v] = TwoLevelAssigner.from_state(
            centroids, r0.supers.cpu().numpy(), r0.members.cpu().numpy(),
            r0.member_valid.cpu().numpy(), w=w)
    return out


class ABStream:
    """The A/B over a stream of batches: the twins (``exact`` first), the
    routed variants' assigners, seconds of assignment per variant, each
    routed variant's drift series and the ground truth of ``queries``."""

    def __init__(self, idxs: dict, assigners: dict, queries: torch.Tensor):
        self.idxs, self.routers = idxs, assigners
        self.assign_s = dict.fromkeys(idxs, 0.0)
        self.drift = {v: [] for v in assigners}
        self.gt = scale3.TopOne(queries)

    def add(self, bi: int, off: int, blk: torch.Tensor) -> dict:
        """Batch ``bi``, rows ``blk`` [n, d] on the device with ids off ..
        off + n - 1: assigned by each variant, encoded into its twin,
        merged into the ground truth. Returns the keys [n] int32 (host) by
        variant."""
        n = blk.shape[0]
        xids = np.arange(off, off + n, dtype=np.int32)
        t = time.perf_counter()
        keys = {"exact": self.idxs["exact"]._assign_device_exact(blk)}
        self.assign_s["exact"] += time.perf_counter() - t
        for v, r in self.routers.items():
            t = time.perf_counter()
            keys[v] = r.assign_device(blk)
            self.assign_s[v] += time.perf_counter() - t
            self.drift[v].append({"batch": bi, "match_rate": float(
                (keys[v] == keys["exact"]).mean())})
        for v, ix in self.idxs.items():
            codes, ncodes = ix._encode_batch(blk, torch.as_tensor(
                keys[v], device=ix.device).long())
            ix.builder.add(keys[v], xids, codes.cpu().numpy(),
                           ncodes.cpu().numpy())
            ix.store = None
        self.gt.merge(blk, off)
        return keys


def evaluate(ab: ABStream, queries: np.ndarray, nb: int, nprobe: int,
             max_codes: int, on_twin=None) -> dict:
    """Finalize and search each twin (k=100 at ``nprobe`` / ``max_codes``
    under its profiled budget); the record with the JAX rig's keys.
    ``on_twin(variant, index, params, queries)``, when given, sees each
    twin before its device tensors are released."""
    gt = ab.gt.labels.cpu().numpy()
    nc = ab.idxs["exact"].nc
    out = {"nb": nb, "nc": nc, "nprobe": nprobe, "max_codes": max_codes,
           "corpus": CORPUS, "variants": {}}
    for v, ix in ab.idxs.items():
        ix.finalize()
        sizes = ix.store.list_sizes()
        prm, dem = bench.profiled(ix, queries, SearchParams(
            k=100, nprobe=nprobe, max_codes=max_codes))
        ix.search(queries[:SEARCH_BATCH], prm, batch=SEARCH_BATCH)
        t = time.perf_counter()
        _, labels = ix.search(queries, prm, batch=SEARCH_BATCH)
        search_s = time.perf_counter() - t
        rec = recall_at_k(labels, gt, ks=(1, 10, 100))
        e = {"recall_at_1": rec[1], "recall_at_10": rec[10],
             "recall_at_100": rec[100], "assign_seconds": ab.assign_s[v],
             "search_seconds_unpipelined": search_s,
             "list_size_max": int(sizes.max()),
             "list_size_p99": int(np.percentile(sizes, 99)),
             "empty_lists": int((sizes == 0).sum()),
             "scan_slots_profiled": dem}
        if v in ab.drift:
            rates = [d["match_rate"] for d in ab.drift[v]]
            e.update(mean_match_rate=float(np.mean(rates)),
                     drift_min_match_rate=min(rates),
                     drift_series=ab.drift[v])
        out["variants"][v] = e
        bench.log(f"assign_ab {v}: R@1 {rec[1]:.4f} R@10 {rec[10]:.4f} "
                  f"R@100 {rec[100]:.4f}, assign {ab.assign_s[v]:.1f} s, "
                  f"lists max {e['list_size_max']} empty "
                  f"{e['empty_lists']}")
        if on_twin is not None:
            on_twin(v, ix, prm, queries)
        ix.release_device()
    return out


def summary(out: dict) -> dict:
    """The record without the drift series (the JSON line, and the
    bench's ``scale3sl_assign_ab`` variants)."""
    return {**{k: x for k, x in out.items() if k != "variants"},
            "variants": {v: {k: x for k, x in e.items()
                             if k != "drift_series"}
                         for v, e in out["variants"].items()}}


def run(device, S: dict, cache: str, nb: int = 16_777_216,
        nprobe: int = 128, max_codes: int = 100_000, on_twin=None) -> dict:
    """The A/B over min(nb, GS_NB) rows of the bench sizes ``S``, on the
    centroids of ``cache``'s grouping_scale stage; writes
    ``<cache>/assign_ab.json`` and returns the record."""
    gs = os.path.join(cache, "grouping_scale")
    p_cent = os.path.join(gs, "centroids.npy")
    if not os.path.exists(p_cent):
        raise FileNotFoundError(
            f"missing {p_cent}: run the bench tool's grouping_scale stage "
            "first (the A/B reuses its SIFT-like centroid set)")
    nb = min(nb, S["GS_NB"])
    cents = np.load(p_cent)
    gen = SiftLikeDeviceGen(device, n_classes=S["S3SL_NCLS"],
                            sigma=S["S3SL_SIGMA"], seed=SEEDS["corpus"],
                            skew=S["S3SL_SKEW"])
    queries = gen.batch_device(SEEDS["queries"], S["GS_NQ"])
    proto = IVFADCIndex(IndexConfig(d=S["D"], nc=cents.shape[0],
                                    code_size=S["CODE_SIZE"]), device)
    proto.set_centroids(cents)
    shared_quantizers(proto, gen, nb, gs)
    ab = ABStream(twins(proto), routers(proto.centroids), queries)
    bench.log(f"assign_ab: {nb} vectors x {len(VARIANTS)} assignment "
              "variants ...")
    t0 = time.perf_counter()
    for bi, off in enumerate(range(0, nb, BATCH)):
        blk = gen.batch_device(SEEDS["base"] + bi, min(BATCH, nb - off))
        ab.add(bi, off, blk)
        bench.log(f"  {off + blk.shape[0]}/{nb} "
                  f"({time.perf_counter() - t0:.0f} s)")
        del blk
    gen.release()
    out = evaluate(ab, queries.cpu().numpy(), nb, nprobe, max_codes,
                   on_twin)
    bench._dump(os.path.join(cache, "assign_ab.json"), out)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.assign_ab",
        description="Exact against routed (w=4, w=16) assignment: three "
                    "index twins over one SIFT-like stream.")
    ap.add_argument("--nb", type=int, default=16_777_216)
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument("--max-codes", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's BENCH_SMOKE sizes (also BENCH_SMOKE=1)")
    a = ap.parse_args(argv)
    device = scale3.resolve_device(a.device)
    smoke = a.smoke or scale3.smoke()
    try:
        out = run(device, bench.sizes(smoke), bench.cache_root(smoke), a.nb,
                  a.nprobe, a.max_codes)
    except FileNotFoundError as e:
        sys.exit(str(e))
    print(json.dumps(summary(out)), flush=True)
    return out


if __name__ == "__main__":
    main()
