"""The exact-ADC ceiling of the SIFT-like device corpus at a density of
the canonical geometry: the counterpart of the JAX rig
``tools/siftlike_scale_calibrate.py``.

For each spec ``sigma:n_classes[:skew]`` (default 0.75:1048576:3):
``SiftLikeDeviceGen(n_classes, sigma, seed=0, skew)``; centroids trained
(4 Lloyd rounds, generator seed 2) on 2,097,152 rows of seed 1; PQ + norm
PQ (generator seed 3) on the first 262,144 of them; NB rows added in
batches of 2^20 (batch i from seed 10,000 + i) with ``add_batch_device``
while the exact top-1 of NQ held-out queries (seed 999,999) is merged in
full f32; then ``tools/bench.py::exact_adc_ceiling`` (brute-force ADC over
every stored code) at R@1 / R@10.

The constants are the JAX rig's, ``CODE_SIZE = 128`` included. That is 128
bytes, so 128 sub-quantizers of one dimension each (``IndexConfig.pq_m =
code_size * 8 // nbits``), although the JAX rig's comment calls it the
16-byte codes of the bench stages; its ceiling near 0.96 at 128 codes a
list is that near-lossless code's. The copy keeps the constant, so the two
rigs measure the same thing; :func:`probe` takes every size as a keyword,
``code_size=16`` gives the bench stages' codes on the same corpus.

    python -m ivfhnsw_tpu_torch.tools.siftlike_scale_calibrate
        [sigma:n_classes[:skew] ...] [--device cuda]

Prints ``RESULT sigma=... n_classes=... skew=... ceiling_at_1=...`` per
spec, as the JAX rig does; progress on stderr.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ivfhnsw_tpu_torch.drivers.common import _sync
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.tools import bench, scale3
from ivfhnsw_tpu_torch.utils.config import IndexConfig
from ivfhnsw_tpu_torch.utils.siftlike import SiftLikeDeviceGen

NB = 8 * 1024 * 1024
NC = 1 << 16
NQ = 256
D = 128
CODE_SIZE = 128  # bytes: pq_m 128 of dsub 1, the JAX rig's constant
LEARN = 2_097_152
PQ_ROWS = 262_144
BATCH = 1_048_576
DEFAULT_SPEC = "0.75:1048576:3"


def parse_spec(a: str) -> tuple:
    """``sigma:n_classes[:skew]`` -> (sigma, n_classes, skew), skew 1.0
    when left out."""
    parts = a.split(":")
    return (float(parts[0]), int(parts[1]),
            float(parts[2]) if len(parts) > 2 else 1.0)


def probe(sigma: float, ncls: int, skew: float, device, *, nb: int = NB,
          nc: int = NC, nq: int = NQ, code_size: int = CODE_SIZE,
          learn: int = LEARN, log=bench.log) -> dict:
    """The ceiling {1: R@1, 10: R@10} of one spec at these sizes."""
    t0 = time.perf_counter()
    tag = f"sigma={sigma} ncls={ncls} skew={skew} code_size={code_size}"
    gen = SiftLikeDeviceGen(device, n_classes=ncls, sigma=sigma, seed=0,
                            skew=skew)
    idx = IVFADCIndex(IndexConfig(d=D, nc=nc, code_size=code_size), device)
    x = gen.batch_device(1, min(learn, nb))
    idx.train_centroids(torch.Generator(device=device).manual_seed(2), x,
                        niter=4)
    idx.train_pq(torch.Generator(device=device).manual_seed(3),
                 x[:PQ_ROWS])
    del x
    log(f"  {tag}: trained ({time.perf_counter() - t0:.0f} s)")
    queries = gen.batch_device(999_999, nq)      # held out: never added
    gt = scale3.TopOne(queries)
    for bi, off in enumerate(range(0, nb, BATCH)):
        blk = gen.batch_device(10_000 + bi, min(BATCH, nb - off))
        idx.add_batch_device(blk, np.arange(off, off + blk.shape[0],
                                            dtype=np.int32))
        gt.merge(blk, off)
        del blk
    idx.finalize()
    gen.release()
    _sync(device)
    log(f"  {tag}: built {nb} ({time.perf_counter() - t0:.0f} s)")
    ceil, _ = bench.exact_adc_ceiling(idx, queries.cpu().numpy(),
                                      gt.labels.cpu().numpy(), ks=(1, 10),
                                      blk=131_072)
    idx.release_device()
    log(f"  {tag}: ceiling@1={ceil[1]:.4f} ceiling@10={ceil[10]:.4f} "
        f"({time.perf_counter() - t0:.0f} s)")
    return ceil


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.siftlike_scale_calibrate",
        description="Exact-ADC ceiling of the SIFT-like device corpus per "
                    "sigma:n_classes[:skew] spec.")
    ap.add_argument("specs", nargs="*", default=[DEFAULT_SPEC])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = scale3.resolve_device(a.device)
    specs = [parse_spec(x) for x in a.specs]
    print(f"probe: nb={NB} nc={NC} code_size={CODE_SIZE} sweep={specs}",
          flush=True)
    out = []
    for s, n, sk in specs:
        c = probe(s, n, sk, device)
        print(f"RESULT sigma={s} n_classes={n} skew={sk} "
              f"ceiling_at_1={c[1]:.4f}", flush=True)
        out.append({"sigma": s, "n_classes": n, "skew": sk,
                    "ceiling_at_1": c[1], "ceiling_at_10": c[10]})
    return out


if __name__ == "__main__":
    main()
