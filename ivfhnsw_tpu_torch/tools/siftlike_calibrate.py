"""The exact-ADC ceiling of the host SIFT-like corpus at 16-byte codes, per
sigma: the counterpart of the JAX rig ``tools/siftlike_calibrate.py``.

For each sigma (default 0.35, 0.55, 0.75): ``SiftLikeCorpus(n_classes=
16384, sigma, seed=1)`` on the host (bit-equal to the JAX package's), NB =
512,000 base rows in batches of 64,000 (seeds 100 + i) and NQ = 1024
held-out queries (seed 999); an IVFADC index at nc 2048, code_size 16:
centroids (8 Lloyd rounds) on the first 300,000 rows and PQ on the first
65,536 (generator seed 0), every row added; the exact top-1 of each query
computed on the device at full f32 (TF32 off); then ``tools/bench.py::
exact_adc_ceiling`` at R@1 / R@10.

    python -m ivfhnsw_tpu_torch.tools.siftlike_calibrate [sigma ...]
        [--device cuda]

Prints ``sigma=...: ceiling@1=... ceiling@10=...`` per sigma, as the JAX
rig does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.tools import bench, scale3
from ivfhnsw_tpu_torch.utils.config import IndexConfig
from ivfhnsw_tpu_torch.utils.siftlike import SiftLikeCorpus

NB, NQ, NC = 512_000, 1024, 2048
N_CLASSES, CORPUS_SEED, QUERY_SEED = 16384, 1, 999
BASE_BATCH = 64_000
SIGMAS = (0.35, 0.55, 0.75)


def corpus(sigma: float) -> tuple:
    """(base [NB, 128], queries [NQ, 128]) float32, the JAX rig's draws."""
    c = SiftLikeCorpus(n_classes=N_CLASSES, sigma=sigma, seed=CORPUS_SEED)
    base = np.concatenate([c.batch(BASE_BATCH, seed=100 + i)
                           for i in range(NB // BASE_BATCH)])
    return base, c.batch(NQ, seed=QUERY_SEED)


def ceiling_for(sigma: float, device) -> dict:
    """{1: ceiling@1, 10: ceiling@10} at ``sigma``."""
    base, queries = corpus(sigma)
    gen = torch.Generator(device=device).manual_seed(0)
    idx = IVFADCIndex(IndexConfig(d=128, nc=NC, code_size=16), device)
    idx.train_centroids(gen, base[:300_000], niter=8)
    idx.train_pq(gen, base[:65_536])
    idx.add_batch(base, np.arange(NB, dtype=np.int32))
    idx.finalize()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gt = streaming_topk_l2(torch.tensor(queries, device=device),
                               torch.tensor(base, device=device), 1,
                               block=131_072)[1].cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ceil, _ = bench.exact_adc_ceiling(idx, queries, gt, ks=(1, 10))
    idx.release_device()
    return ceil


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.siftlike_calibrate",
        description="Exact-ADC ceiling of the host SIFT-like corpus at "
                    "16-byte codes per sigma.")
    ap.add_argument("sigmas", nargs="*", type=float, default=list(SIGMAS))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = scale3.resolve_device(a.device)
    out = {}
    for s in a.sigmas:
        c = ceiling_for(s, device)
        print(f"sigma={s}: ceiling@1={c[1]:.4f} ceiling@10={c[10]:.4f}",
              flush=True)
        out[s] = c
    return out


if __name__ == "__main__":
    main()
