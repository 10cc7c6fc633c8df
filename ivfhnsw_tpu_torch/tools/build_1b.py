"""Billion-vector assign + encode on one card: the counterpart of
``tools/build_1b.py``, with its flags, steps, files and report fields.

    the scale3 corpus drawn on the device (tools/scale3.py: one generator
    seed per batch, so a resumed run regenerates the same bytes)
      -> routed two-level assignment at nc=2^20 (ops/hierarchical.py),
         held to >= 0.98 exact matches on 8192 rows before the build
         starts, and sampled every 32 batches while it runs
      -> PQ encode on the device (IVFADCIndex._encode_batch)
      -> the crash-safe spill of parallel/pipeline.py
         (StreamedIndexBuild.add_precomputed: spill files, fsync, atomic
         cursor; 25 B a vector, 25 GB at 1e9, of which the store keeps 21:
         the 16 B code, the norm code and the id)
      -> the exact top-1 of 1024 held-out queries, merged batch by batch
         and checkpointed beside the cursor: the ground truth of
         tools/search_1b.py.

The prerequisites are built only when missing, at the paths of the JAX
tool (``<cache>/scale3/``): hierarchical seeding at k = nc over 8,388,608
rows (``seeds.npy`` checkpoints it), two routed Lloyd rounds whose cluster
sums are the deterministic ``ops/segment.py::segment_sum`` on the device
(``centroids.npy``), PQ and norm-PQ on 262,144 rows (``scale3.pq``,
``scale3.norm_pq``).

Kill it and run it again: it resumes from the committed cursor, catches
the ground truth up to it, and counts the resume in ``meta.json``. If the
sampled match rate falls below 0.98 the rest of the build assigns exactly
and ``meta.json`` records ``routed_abandoned_at_batch``: the JAX tool's
policy, not a device fallback. Progress, and the final totals, go to
``build1b.json`` in the cache directory (tools/scale3.py:
``.bench_cache_torch/`` unless BENCH_CACHE_DIR says otherwise). The tool
never writes ``RESULTS_1B.json``: that file is the TPU's record, and the
JAX tool's mirror into it (``_publish``, tools/build_1b.py:73-89) has no
counterpart here.

    python -m ivfhnsw_tpu_torch.tools.build_1b [--target 1000000000]
        [--batch 2097152] [--workdir DIR] [--device cuda]

``--device`` defaults to cuda and raises without a card; ``--device cpu``
runs the same steps on the CPU (with BENCH_SMOKE=1 for its geometry).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ivfhnsw_tpu_torch.drivers.common import _sync
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.ops.hierarchical import TwoLevelAssigner
from ivfhnsw_tpu_torch.ops.kmeans import hierarchical_seed
from ivfhnsw_tpu_torch.ops.segment import segment_sum
from ivfhnsw_tpu_torch.parallel.mesh import make_mesh
from ivfhnsw_tpu_torch.parallel.pipeline import StreamedIndexBuild
from ivfhnsw_tpu_torch.tools import scale3
from ivfhnsw_tpu_torch.utils.config import IndexConfig

NQ_GT = 1024
MATCH_GATE = 0.98
DRIFT_EVERY = 32          # batches between drift samples
LEARN_ROWS, PQ_ROWS, MATCH_ROWS, DRIFT_ROWS = 8_388_608, 262_144, 8192, 1024
LOG_EVERY_S = 60.0


class Stages:
    """Host seconds per named stage, the device synced at each end."""

    def __init__(self, device, seconds: dict | None = None):
        self.device, self.seconds = device, dict(seconds or {})

    def __call__(self, name: str, fn):
        t = time.perf_counter()
        r = fn()
        _sync(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t)
        return r


def routed_match(idx, sample: torch.Tensor, n_super: int, seed: int
                 ) -> float:
    """Set up the routed two-level assigner on ``idx`` (w=4, ``n_super``
    super-clusters, generator seed ``seed``) and return the share of
    ``sample`` that it assigns as the exact sweep does: the rate that
    MATCH_GATE is held against."""
    idx.enable_fast_assign(w=4, n_super=n_super, generator=torch.Generator(
        device=idx.device).manual_seed(seed))
    exact = idx._assign_device_exact(sample)
    return float((idx._fast_assigner.assign_device(sample) == exact).mean())


def routed_lloyd(cents: torch.Tensor, learn: torch.Tensor, n_super: int,
                 rounds: int = 2, seed: int = 90) -> torch.Tensor:
    """``rounds`` Lloyd rounds whose assignment is the routed two-level
    assigner (w=4, generator seed ``seed`` + round: the JAX recipes' keys,
    90 here and 290 in the bench's grouping_scale) and
    whose cluster sums are deterministic segment sums; an empty cluster
    keeps its centroid."""
    nc = cents.shape[0]
    for it in range(rounds):
        assigner = TwoLevelAssigner(
            cents, n_super=n_super, w=4,
            generator=torch.Generator(device=cents.device).manual_seed(
                seed + it))
        keys = assigner.assign_tensor(learn)
        del assigner
        ones = torch.ones((learn.shape[0], 1), device=learn.device)
        acc = segment_sum(torch.cat([learn, ones], dim=1), keys, nc)
        counts = acc[:, -1]
        nz = counts > 0
        cents = cents.clone()
        cents[nz] = acc[nz, :-1] / counts[nz, None]
        del acc, keys
        print(f"Lloyd iter {it} done ({int(nz.sum())} non-empty)",
              flush=True)
    return cents


def prerequisites(idx: IVFADCIndex, corpus, sdir: str, stages: Stages) -> bool:
    """Install the centroids and quantizers of ``sdir`` into ``idx``,
    building (and checkpointing) each one that is missing. Returns whether
    any was built."""
    g = scale3.geometry()
    p_cent = os.path.join(sdir, "centroids.npy")
    p_seeds = os.path.join(sdir, "seeds.npy")
    p_pq = os.path.join(sdir, "scale3.pq")
    p_npq = os.path.join(sdir, "scale3.norm_pq")
    if all(os.path.exists(p) for p in (p_cent, p_pq, p_npq)):
        idx.set_centroids(np.load(p_cent))
        idx.load_quantizers(p_pq, p_npq)
        return False
    dev = idx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    if os.path.exists(p_cent):
        idx.set_centroids(np.load(p_cent))
    else:
        t_pre = time.perf_counter()
        learn = stages("learn_draw", lambda: corpus.gen(
            scale3.LEARN_SEED, min(LEARN_ROWS, g["nb"])))
        if os.path.exists(p_seeds):
            seeds = torch.tensor(np.load(p_seeds), device=dev)
            print("resuming from checkpointed seeds", flush=True)
        else:
            print(f"hierarchical seeding k={g['nc']} ...", flush=True)
            seeds = stages("seeding", lambda: hierarchical_seed(
                gen, learn, g["nc"]))
            np.save(p_seeds, seeds.cpu().numpy())
        cents = stages("lloyd", lambda: routed_lloyd(
            seeds, learn, min(2048, g["nc"] // 4)))
        del learn, seeds
        idx.set_centroids(cents)
        np.save(p_cent, cents.cpu().numpy())
        os.remove(p_seeds)
        with open(os.path.join(sdir, "build_progress.json"), "w") as f:
            json.dump({"centroid_seconds":
                       round(time.perf_counter() - t_pre, 1)}, f)
    if os.path.exists(p_pq):
        idx.load_quantizers(p_pq, p_npq)
    else:
        learn = corpus.gen(scale3.PQ_SEED, min(PQ_ROWS, g["nb"]))
        print("training PQ ...", flush=True)
        stages("pq", lambda: idx.train_pq(gen, learn))
        idx.save_quantizers(p_pq, p_npq)
    return True


def publish(cache: str, meta: dict, processed: int, target: int,
            seconds: float, partial: bool) -> dict:
    """Write ``build1b.json`` into the cache directory atomically with the
    current totals (the JAX tool's fields); returns what it wrote."""
    out = dict(meta)
    out.update({
        "target": target,
        "processed": processed,
        "build_seconds": round(seconds, 1),
        "vectors_per_sec": round(processed / max(seconds, 1e-9), 1),
        "fraction_of_1b": round(processed / 1e9, 4),
        "partial": partial,
    })
    p = os.path.join(cache, "build1b.json")
    with open(p + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(p + ".tmp", p)
    return out


def parse(argv):
    cache = scale3.cache_dir()
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.build_1b",
        description="Billion-vector assign + encode + spill on one card.")
    ap.add_argument("--target", type=int, default=1_000_000_000)
    ap.add_argument("--batch", type=int, default=2_097_152)
    ap.add_argument("--workdir", default=os.path.join(cache, "build1b"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv), cache


def main(argv=None) -> dict:
    """The build; returns the final ``build1b.json`` record."""
    args, cache = parse(argv)
    device = scale3.resolve_device(args.device)
    g = scale3.geometry()
    sdir = os.path.join(cache, "scale3")
    os.makedirs(sdir, exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)

    meta_p = os.path.join(args.workdir, "meta.json")
    meta = {"resumes": 0, "drift_series": [], "seconds_so_far": 0.0}
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
    stages = Stages(device, meta.get("stage_seconds"))
    idx = IVFADCIndex(IndexConfig(d=g["d"], nc=g["nc"],
                                  code_size=g["code_size"]), device)
    corpus = stages("corpus_setup", lambda: scale3.scale3_corpus(device))
    t_pre = time.perf_counter()
    if prerequisites(idx, corpus, sdir, stages):
        pre = time.perf_counter() - t_pre
        meta["prereq_seconds"] = round(meta.get("prereq_seconds", 0.0)
                                       + pre, 1)
        print(f"prerequisites ready in {pre:.0f}s", flush=True)

    print("routed assigner setup + match gate ...", flush=True)
    n_super = min(2048, g["nc"] // 4)
    sample = corpus.gen(scale3.SAMPLE_SEED, MATCH_ROWS)
    match = stages("match_gate",
                   lambda: routed_match(idx, sample, n_super, 95))
    meta["match_rate"] = round(match, 4)
    print(f"routed exact-match rate = {match:.4f}", flush=True)
    if match < MATCH_GATE:
        sys.exit("match rate below gate; refusing routed 1B build")

    build = StreamedIndexBuild(idx, make_mesh(devices=[device]),
                               args.workdir)
    if build.processed > 0:
        meta["resumes"] += 1
        print(f"RESUME from committed cursor: {build.processed} vectors "
              f"(resume #{meta['resumes']})", flush=True)
    bs = args.batch
    if build.processed % bs:
        sys.exit("cursor not batch-aligned; was --batch changed?")

    # The in-stream exact ground truth of 1024 held-out queries (a seed
    # no batch uses), checkpointed beside the cursor; a resumed run first
    # merges the batches the spill committed but the checkpoint missed.
    p_q = os.path.join(args.workdir, "queries.npy")
    p_gtl = os.path.join(args.workdir, "gt.npy")
    p_gtd = os.path.join(args.workdir, "gt_d.npy")
    p_gts = os.path.join(args.workdir, "gt_state.json")
    if os.path.exists(p_q):
        queries = torch.tensor(np.load(p_q), device=device)
    else:
        queries = corpus.gen(scale3.QUERY_SEED, NQ_GT)
        np.save(p_q, queries.cpu().numpy())
    gt_done = 0
    gt = scale3.TopOne(queries)
    if os.path.exists(p_gts):
        with open(p_gts) as f:
            gt_done = int(json.load(f)["batches"])
        gt = scale3.TopOne(queries, np.load(p_gtd), np.load(p_gtl))

    def gt_checkpoint(batches):
        np.save(p_gtd, gt.dists.cpu().numpy())
        np.save(p_gtl, gt.labels.cpu().numpy())
        with open(p_gts + ".tmp", "w") as f:
            json.dump({"batches": batches, "nq": NQ_GT}, f)
        os.replace(p_gts + ".tmp", p_gts)

    committed = build.processed // bs
    if gt_done < committed:
        print(f"gt catch-up: merging batches {gt_done}...{committed - 1} "
              "(spill is ahead of gt)", flush=True)
        for bi in range(gt_done, committed):
            off = bi * bs
            gt.merge(corpus.gen(scale3.SEED_BASE + bi,
                                min(bs, args.target - off)), off)
        gt_checkpoint(committed)
        gt_done = committed

    def save_meta():
        meta["stage_seconds"] = {k: round(v, 3)
                                 for k, v in stages.seconds.items()}
        with open(meta_p, "w") as f:
            json.dump(meta, f)

    t0 = time.perf_counter()
    base_s = meta.get("seconds_so_far", 0.0)
    done0, last_log = build.processed, t0
    use_routed = not meta.get("routed_abandoned", False)
    while build.processed < args.target:
        bi = build.processed // bs
        off = build.processed
        n = min(bs, args.target - off)
        blk = stages("draw", lambda: corpus.gen(scale3.SEED_BASE + bi, n))
        keys = stages("assign", lambda: (
            idx._fast_assigner.assign_tensor(blk) if use_routed
            else idx._assign_exact_t(blk)))
        codes, ncodes = stages("encode", lambda: idx._encode_batch(blk,
                                                                   keys))
        stages("ground_truth", lambda: gt.merge(blk, off))
        host = stages("to_host", lambda: (
            keys.to(torch.int32).cpu().numpy(), codes.cpu().numpy(),
            ncodes.cpu().numpy()))
        xids = np.arange(off, off + n, dtype=np.int32)
        stages("commit", lambda: build.add_precomputed(host[0], xids,
                                                       host[1], host[2]))
        gt_done = build.processed // bs
        if use_routed and bi % DRIFT_EVERY == 0:
            samp = blk[:DRIFT_ROWS]
            rate = stages("drift", lambda: float((
                idx._fast_assigner.assign_device(samp)
                == idx._assign_device_exact(samp)).mean()))
            meta["drift_series"].append({"batch": bi,
                                         "match_rate": round(rate, 4)})
            if rate < MATCH_GATE:
                # The JAX tool's policy: a drifting router must not
                # misassign the rest of the run.
                use_routed = False
                meta["routed_abandoned"] = True
                meta["routed_abandoned_at_batch"] = bi
                print(f"drift {rate:.4f} < {MATCH_GATE} gate at batch {bi}; "
                      "falling back to EXACT assignment", flush=True)
        del blk, keys, codes, ncodes, host
        if time.perf_counter() - last_log > LOG_EVERY_S:
            el = time.perf_counter() - t0
            rate_v = (build.processed - done0) / el
            eta = (args.target - build.processed) / max(rate_v, 1)
            print(f"{build.processed / 1e6:.0f}M / {args.target / 1e6:.0f}M"
                  f"  {rate_v / 1e6:.2f}M vec/s  eta {eta / 3600:.2f}h",
                  flush=True)
            last_log = time.perf_counter()
            gt_checkpoint(gt_done)
            meta["seconds_so_far"] = round(base_s + el, 1)
            save_meta()
            publish(cache, meta, build.processed, args.target, base_s + el,
                    partial=True)

    total_s = base_s + time.perf_counter() - t0
    gt_checkpoint(gt_done)
    build.close()
    meta["seconds_so_far"] = round(total_s, 1)
    meta["gt_nq"] = NQ_GT
    meta["device"] = (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")
    meta.update(scale3.peaks(device))
    save_meta()
    meta["spill_bytes"] = sum(
        os.path.getsize(os.path.join(args.workdir, f))
        for f in os.listdir(args.workdir))
    out = publish(cache, meta, build.processed, args.target, total_s,
                  partial=False)
    save_meta()
    print(f"DONE: {build.processed} vectors in {total_s:.0f}s "
          f"({build.processed / max(total_s, 1e-9):.0f} vec/s)", flush=True)
    return out


if __name__ == "__main__":
    main()
