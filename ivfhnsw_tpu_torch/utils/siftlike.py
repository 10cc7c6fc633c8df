"""SIFT-like synthetic corpus. Counterpart of ``ivfhnsw_tpu/utils/siftlike.py``.

A Gaussian mixture puts PQ residual error close to neighbour margins, far
below the recall real SIFT descriptors allow. Real SIFT descriptors are
16 spatial cells x 8 orientation bins of non-negative gradient energy with
log-normal-ish magnitudes, L2-normalized, clipped at 0.2, renormalized and
quantized to uint8 at a 512 scale (Lowe 2004; the bigann readme). These
generators reproduce that pipeline statistically:

1. appearance classes: per class a [16, 8] log-normal cell x bin energy
   field with a dominant orientation per cell (circular spread) and a
   radial cell-magnitude falloff;
2. a sample jitters its class field with multiplicative log-normal noise
   (``sigma``: intra-class tightness, the recall-ceiling knob) and zeroes
   the bins well below its cell's dominant response;
3. SIFT post-processing: L2-normalize, clip at 0.2, renormalize, x512,
   clip to [0, 255], floor -> the uint8 grid, returned as float32.

:class:`SiftLikeCorpus` is numpy on the host, a copy of the JAX package's
(the same seed gives the same bytes). :class:`SiftLikeDeviceGen` runs the
same pipeline with torch on a device; its draws differ from the JAX
package's ``jax.random`` ones, and only the corpus statistics are held
equal. Queries are drawn apart from the base (held out), as the reference
evaluates with disjoint query files (test_ivfhnsw_sift1b.cpp:40-52).
"""

from __future__ import annotations

import numpy as np
import torch

D = 128
CELLS, BINS = 16, 8
_RING = [2, 1, 1, 2, 1, 0, 0, 1, 1, 0, 0, 1, 2, 1, 1, 2]


class SiftLikeCorpus:
    """Deterministic streaming generator (same class field -> same bytes).

    sigma: intra-class multiplicative jitter (log scale), the knob of the
    recall ceiling. Default 0.75, the JAX package's calibration point
    (its tools/siftlike_calibrate.py, an exact-ADC recall expectation at
    16-byte codes, not a measurement of this package).
    """

    def __init__(self, n_classes: int = 65536, sigma: float = 0.75,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.sigma = float(sigma)
        self.n_classes = n_classes
        # Dominant orientation per (class, cell): a base direction per class
        # plus per-cell wobble, energy spread circularly around it.
        dom = rng.randint(0, BINS, size=(n_classes, 1))
        wob = rng.randint(-1, 2, size=(n_classes, CELLS))
        self._dom = ((dom + wob) % BINS).astype(np.int8)      # [ncls, 16]
        # Per-(class, cell) log-energy level: radial falloff (outer cells
        # weaker, as in real patches) + class-specific texture.
        ring = np.asarray(_RING, np.float32)
        self._cell_log = (rng.randn(n_classes, CELLS).astype(np.float32)
                          * 0.9 - 0.45 * ring)
        # Circular orientation profile: energy decays away from dominant.
        self._prof = np.exp(-0.9 * np.minimum(np.arange(BINS),
                                              BINS - np.arange(BINS))
                            ).astype(np.float32)               # [8]

    def _fields(self, cls: np.ndarray, rng) -> np.ndarray:
        n = cls.shape[0]
        dom = self._dom[cls].astype(np.int32)                  # [n, 16]
        shift = (np.arange(BINS)[None, None, :]
                 - dom[:, :, None]) % BINS                     # [n, 16, 8]
        energy = self._prof[shift]                             # [n, 16, 8]
        energy = energy * np.exp(self._cell_log[cls])[:, :, None]
        jit = np.exp(rng.randn(n, CELLS, BINS).astype(np.float32)
                     * self.sigma)
        v = energy * jit
        # Empty bins: real SIFT histograms have no gradient mass in ~half
        # the (cell, bin) slots (zero fraction ~0.45 in bigann SIFT1M);
        # energies well below a cell's dominant response get no votes.
        v[v < 0.22 * v.max(axis=2, keepdims=True)] = 0.0
        return v.astype(np.float32)

    def batch(self, n: int, seed: int) -> np.ndarray:
        """n SIFT-like uint8 descriptors as float32 [n, 128] (the drivers
        promote uint8 .bvecs to f32 the same way, utils.h:112-127)."""
        rng = np.random.RandomState(seed)
        cls = rng.randint(0, self.n_classes, n)
        v = self._fields(cls, rng).reshape(n, D)
        # SIFT post-processing: normalize -> clip 0.2 -> renormalize ->
        # x512 -> uint8.
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        v = np.minimum(v, 0.2)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        q = np.clip(np.floor(v * 512.0), 0, 255).astype(np.uint8)
        return q.astype(np.float32)



class SiftLikeDeviceGen:
    """The generative process of :class:`SiftLikeCorpus` on ``device``
    with torch, so that a large corpus is drawn where it is indexed instead
    of crossing from host numpy. The class tables (``n_classes`` x 16
    orientations and log-energies) live on the device until
    :meth:`release`.

    ``skew`` sets class popularity: cls = floor(n_classes * u^skew), u
    uniform; 1 is uniform, above 1 concentrates mass on low class ids
    (Zipf-like, as bursty near-duplicate patches are in real SIFT)."""

    def __init__(self, device, n_classes: int = 1 << 22, sigma: float = 0.75,
                 seed: int = 0, skew: float = 1.0):
        self.device = torch.device(device)
        self.n_classes = int(n_classes)
        self.sigma = float(sigma)
        self.skew = float(skew)
        g = torch.Generator(device=self.device).manual_seed(seed)
        dom = torch.randint(0, BINS, (self.n_classes, 1), generator=g,
                            device=self.device)
        wob = torch.randint(-1, 2, (self.n_classes, CELLS), generator=g,
                            device=self.device)
        ring = torch.tensor(_RING, dtype=torch.float32, device=self.device)
        self._state = {
            "dom": ((dom + wob) % BINS).to(torch.int8),
            "cell_log": (torch.randn((self.n_classes, CELLS), generator=g,
                                     device=self.device) * 0.9 - 0.45 * ring),
        }
        b = torch.arange(BINS, device=self.device)
        self._prof = torch.exp(-0.9 * torch.minimum(b, BINS - b).float())

    def batch_device(self, seed: int, n: int) -> torch.Tensor:
        """n SIFT-like descriptors on the uint8 grid as f32 [n, 128] on the
        device, drawn from a generator seeded with ``seed`` alone: the same
        seed gives the same tensor."""
        dom_t, cell_log = self._state["dom"], self._state["cell_log"]
        if dom_t is None:
            raise RuntimeError("class tables released")
        g = torch.Generator(device=self.device).manual_seed(seed)
        if self.skew != 1.0:
            u = torch.rand(n, generator=g, device=self.device)
            cls = ((u ** self.skew) * self.n_classes).long().clamp(
                0, self.n_classes - 1)
        else:
            cls = torch.randint(0, self.n_classes, (n,), generator=g,
                                device=self.device)
        domb = dom_t[cls].long()                               # [n, 16]
        shift = (torch.arange(BINS, device=self.device)[None, None, :]
                 - domb[:, :, None]) % BINS                    # [n, 16, 8]
        energy = self._prof[shift] * torch.exp(cell_log[cls])[:, :, None]
        jit = torch.exp(torch.randn((n, CELLS, BINS), generator=g,
                                    device=self.device) * self.sigma)
        v = energy * jit
        v = torch.where(v < 0.22 * v.amax(dim=2, keepdim=True), 0.0, v)
        v = v.reshape(n, D)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        v = torch.clamp(v, max=0.2)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        return torch.clamp(torch.floor(v * 512.0), 0.0, 255.0)

    def release(self) -> None:
        """Free the device-resident class tables."""
        self._state["dom"] = None
        self._state["cell_log"] = None
