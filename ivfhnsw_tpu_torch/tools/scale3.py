"""The scale3 recipe of the billion-scale tools: the counterpart of
``bench.py``'s scale3 geometry (``bench.py:76-83``), its ``BENCH_SMOKE``
geometry (``:133-160``) and ``make_scale3_gen`` (``:1078-1120``), kept here
because ``bench.py`` imports JAX and the port never does.

The corpus (:class:`MesoCorpus`): n_sup = min(2048, nc / 4) supers drawn
N(0, 5^2) and a mixing matrix from ``np.random.RandomState(11)``, bit for
bit the JAX bench's draws; nc mids around the supers (N(0, 1.5^2)) and the
points ``mids[a] + (noise * spectrum @ mix) * 0.7`` drawn on the device
from ``torch.Generator`` seeds, one seed per call, so a resumed build
regenerates the same bytes. (The JAX bench draws the mids and points with
``jax.random``, so the two packages' corpora differ from there on.)

The environment, read at each call as the JAX tools read it:

- ``BENCH_SMOKE=1`` selects the smoke geometry (nb 32,768, nc 1,024);
- ``BENCH_CACHE_DIR`` overrides the cache directory, by default
  ``.bench_cache_torch/`` at the root of the checkout. Never the JAX
  package's ``.bench_cache/``: the port's centroids, quantizers and spills
  come from another corpus, so the two packages must not share them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2

D, CODE_SIZE = 128, 16
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Generator seeds of the JAX recipe's PRNG keys (bench.py:1104,
# tools/build_1b.py:123-240): mids, learn rows, PQ rows, match sample,
# held-out queries, and the base of the build's batch seeds.
MIDS_SEED, LEARN_SEED, PQ_SEED, SAMPLE_SEED = 83, 85, 86, 97
QUERY_SEED, SEED_BASE = 999_555, 5000
GT_BLOCK = 131_072   # base rows per step of the ground-truth sweep


def smoke() -> bool:
    return os.environ.get("BENCH_SMOKE") == "1"


def geometry() -> dict:
    """The scale3 point (nb, which caps the learn rows, nc, d, code_size),
    or the smoke point under BENCH_SMOKE=1 (the tools' search flags carry
    nprobe, max_codes and k)."""
    nb, nc = ((32_768, 1_024) if smoke() else (134_217_728, 1_048_576))
    return {"nb": nb, "nc": nc, "d": D, "code_size": CODE_SIZE}


def cache_dir() -> str:
    """BENCH_CACHE_DIR (an empty value counts as unset), else
    ``.bench_cache_torch/`` at the root of the checkout."""
    return (os.environ.get("BENCH_CACHE_DIR")
            or os.path.join(ROOT, ".bench_cache_torch"))


def resolve_device(name: str) -> torch.device:
    """The ``--device`` of a tool: a CUDA device without a card is an
    error, never a fall-back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return device


def peaks(device: torch.device) -> dict:
    """This process's peak host RSS and (on a card) peak device memory
    allocated, GiB."""
    import resource
    out = {"host_peak_rss_gib": round(resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 3)}
    if device.type == "cuda":
        out["device_peak_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    return out


class MesoCorpus:
    """The JAX bench's two-level corpus: n_sup = min(2048, nc / 4) supers
    (N(0, 5^2)), nc mids around them (N(0, 1.5^2)), points mids[a] +
    (noise * spectrum @ mix) * 0.7 with spectrum i^-1/2. The supers, the
    mix and (scale2, bench.py:993-1015) the mids come from numpy
    RandomState(np_seed); with ``mids_seed`` (scale3, bench.py:1078-1120)
    the mids are drawn on the device from that generator seed. Points are
    drawn on the device, one torch.Generator seed per call."""

    def __init__(self, device, nc: int, d: int, np_seed: int,
                 mids_seed: int | None = None):
        rng = np.random.RandomState(np_seed)
        n_sup = min(2048, nc // 4)
        supers = rng.randn(n_sup, d).astype(np.float32) * 5.0
        if mids_seed is None:
            mids = (np.repeat(supers, nc // n_sup, axis=0)
                    + rng.randn(nc, d).astype(np.float32) * 1.5)
        self.mix = torch.tensor((rng.randn(d, d).astype(np.float32)
                                 / np.sqrt(d)).astype(np.float32),
                                device=device)
        self.supers = torch.tensor(supers, device=device)
        if mids_seed is None:
            self.mids = torch.tensor(mids, device=device)
        else:
            g = torch.Generator(device=device).manual_seed(mids_seed)
            self.mids = torch.repeat_interleave(self.supers, nc // n_sup,
                                                dim=0)
            self.mids += torch.randn((nc, d), generator=g,
                                     device=device) * 1.5
        self.spectrum = torch.tensor(
            (np.arange(1, d + 1) ** -0.5).astype(np.float32), device=device)
        self.device, self.nc, self.d = device, nc, d

    def gen(self, seed: int, n: int) -> torch.Tensor:
        """[n, d] f32 points on the device, the same for the same seed."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        a = torch.randint(0, self.nc, (n,), generator=g, device=self.device)
        noise = torch.randn((n, self.d), generator=g, device=self.device)
        return self.mids[a] + ((noise * self.spectrum) @ self.mix) * 0.7


def scale3_corpus(device, nc: int | None = None) -> MesoCorpus:
    """The scale3 corpus at ``nc`` mids (default: the geometry's)."""
    return MesoCorpus(device, nc or geometry()["nc"], D, 11,
                      mids_seed=MIDS_SEED)


class TopOne:
    """The exact nearest base row of each of a fixed set of queries, merged
    over a stream of base batches (the in-stream ground truth of the JAX
    tools, tools/build_1b.py:200-253): a batch's own top-1 by
    ``streaming_topk_l2`` in full f32 (TF32 off), then kept where strictly
    nearer, so the earlier row wins a tie. ``dists`` [nq, 1] f32 and
    ``labels`` [nq, 1] int64 live on the queries' device."""

    def __init__(self, queries: torch.Tensor, dists=None, labels=None):
        self.q = queries
        nq, dev = queries.shape[0], queries.device
        self.dists = (torch.full((nq, 1), float("inf"), device=dev)
                      if dists is None else torch.as_tensor(dists).to(dev))
        self.labels = (torch.full((nq, 1), -1, dtype=torch.int64, device=dev)
                       if labels is None
                       else torch.as_tensor(labels).to(dev))

    def merge(self, blk: torch.Tensor, off: int) -> None:
        """Fold base rows ``blk`` [n, d], ids off .. off + n - 1, in."""
        d, i = streaming_topk_l2(self.q, blk, 1, block=GT_BLOCK)
        better = d < self.dists
        self.dists = torch.where(better, d, self.dists)
        self.labels = torch.where(better, i + off, self.labels)
