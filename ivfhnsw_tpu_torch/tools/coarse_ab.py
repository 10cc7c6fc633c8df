"""Timed A/B of coarse probe selection on the scale3sl index: the
counterpart of the JAX rig ``tools/coarse_ab.py``.

On the bench tool's cached ``scale3sl`` index (``tools/bench.py::
build_scale3sl``: read from ``<cache>/scale3sl/`` when it is there, else
built) it searches under ``coarse_mode`` "auto" and "binned" at nprobe 128,
max_codes 100k, k = K, each under its profiled scan budget through the
bench tool's ``timed_qps`` (sustained: 8 launches per synchronize, the
best of ``--runs`` single launches), with R@1/10; then the probe-set
overlap of each mode against the exact sweep on the first 64 queries:
"binned" through ``streaming_topk_l2(exact_reduce="binned")``, "auto"
through ``streaming_topk_l2(approx=True, recall_target=0.95)``, as the JAX
rig measures its ``approx_min_k``. Two differences follow from the port's
divergence D1: the port's "approx" is a bucketed partial reduction, and its
"auto" without a routed structure resolves to exact selection, so the
timed "auto" search is exact coarse; ``coarse_resolved`` says what each
mode resolved to. Writes ``<cache>/coarse_ab.json`` (the bench tool's
``scale3sl_coarse_ab``) and prints it as one JSON line.

    python -m ivfhnsw_tpu_torch.tools.coarse_ab [--nprobe 128]
        [--max-codes 100000] [--runs 2] [--device cuda] [--smoke]

The probe selection replaces the reference's graph walk (hnswalg.cpp:
48-109).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.tools import bench, scale3
from ivfhnsw_tpu_torch.utils.config import SearchParams
from ivfhnsw_tpu_torch.utils.recall import recall_at_k

MODES = ("auto", "binned")
N_CTL = 64


def probe_overlap(probes: np.ndarray, exact: np.ndarray) -> float:
    """The JAX rig's overlap: the mean over rows i of |set(probes[i]) &
    set(exact[i])| / exact.shape[1] (duplicates count once)."""
    return float(np.mean([len(np.intersect1d(probes[i], exact[i]))
                          / exact.shape[1] for i in range(probes.shape[0])]))


def mode_probes(idx, q: torch.Tensor, nprobe: int, mode: str
                ) -> torch.Tensor:
    """The probes [n, nprobe] of the JAX rig's overlap line for ``mode``:
    the binned exact reduction, or ("auto") the approx one at recall
    target 0.95, over the sweep block of a batch of ``n`` queries."""
    kw = dict(block=idx._coarse_block_for(q.shape[0]),
              point_sqnorms=idx.centroid_norms)
    if mode == "binned":
        kw["exact_reduce"] = "binned"
    else:
        kw.update(approx=True, recall_target=0.95)
    return streaming_topk_l2(q, idx.centroids, nprobe, **kw)[1]


def resolved(idx, params: SearchParams, nprobe: int) -> str:
    """What the fused engine's coarse step runs under ``params``."""
    c = idx._coarse_for(params, nprobe)
    if "routed" in c:
        return "routed"
    return ("approx" if c["approx"] else
            "binned" if c["exact_reduce"] == "binned" else "exact")


def measure(idx, q: np.ndarray, gt: np.ndarray, k: int, nprobe: int,
            max_codes: int, runs: int) -> dict:
    """The A/B record (without nb / nc) on one built index."""
    qt = torch.tensor(np.asarray(q, np.float32), device=idx.device)
    exact = streaming_topk_l2(qt, idx.centroids, nprobe, block=idx._cb(),
                              point_sqnorms=idx.centroid_norms)[1]
    exact = exact.cpu().numpy()
    n_ctl = min(N_CTL, q.shape[0])
    out = {"nprobe": nprobe, "max_codes": max_codes, "modes": {}}
    for mode in MODES:
        prm, dem = bench.profiled(idx, q, SearchParams(
            k=k, nprobe=nprobe, max_codes=max_codes, coarse_mode=mode))
        qps, labels, sl_us = bench.timed_qps(idx, q, prm, runs=runs,
                                             depth=bench.DEPTH)
        rec = recall_at_k(labels, gt, ks=(1, 10))
        pr = mode_probes(idx, qt[:n_ctl], nprobe, mode).cpu().numpy()
        out["modes"][mode] = {
            "qps": qps, "us_per_query": 1e6 / qps,
            "us_per_query_single_launch": sl_us,
            "recall_at_1": rec[1], "recall_at_10": rec[10],
            "probe_overlap_vs_exact": probe_overlap(pr, exact[:n_ctl]),
            "coarse_resolved": resolved(idx, prm, nprobe),
            "scan_slots_profiled": dem}
        bench.log(f"coarse_ab {mode}: {out['modes'][mode]}")
    a, b = out["modes"]["auto"], out["modes"]["binned"]
    out["binned_minus_auto_us"] = b["us_per_query"] - a["us_per_query"]
    return out


def run(device, S: dict, cache: str, nprobe: int = 128,
        max_codes: int = 100_000, runs: int = 2) -> dict:
    """The A/B on ``cache``'s scale3sl index at the bench sizes ``S``;
    writes ``<cache>/coarse_ab.json`` and returns the record."""
    idx, q, gt, _ = bench.build_scale3sl(S, device, cache)
    try:
        out = {"nb": S["S3SL_NB"], "nc": S["S3SL_NC"],
               **measure(idx, q, gt, S["K"], nprobe, max_codes, runs)}
    finally:
        idx.release_device()
    bench._dump(os.path.join(cache, "coarse_ab.json"), out)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.coarse_ab",
        description="auto against binned-exact coarse selection on the "
                    "scale3sl index, timed end to end.")
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument("--max-codes", type=int, default=100_000)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's BENCH_SMOKE sizes (also BENCH_SMOKE=1)")
    a = ap.parse_args(argv)
    device = scale3.resolve_device(a.device)
    smoke = a.smoke or scale3.smoke()
    cache = bench.cache_root(smoke)
    os.makedirs(cache, exist_ok=True)
    out = run(device, bench.sizes(smoke), cache, a.nprobe, a.max_codes,
              a.runs)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
