"""Corpus laws of the benchmark's deployments, drawn on the device from a
``torch.Generator``. Copies, kept here so that no later change to the
program moves the data:

- ``siftlike``: the SIFT-like pipeline of ``ivfhnsw_tpu_torch/utils/
  siftlike.py::SiftLikeDeviceGen`` (16 cells x 8 orientation bins of
  log-normal energy, jittered, thresholded, L2-normalised, clipped at 0.2,
  renormalised, x512, floored to the uint8 grid). One appearance class per
  coarse list; a list's centroid is its class field without jitter.
- ``deep``: the DEEP-like law of ``ivfhnsw_tpu_torch/tools/bench.py::
  GaussCorpus`` with ``normalized=True``: unit centres, points
  centre + 0.35 * (noise * i^-1/2 spectrum) @ mix, L2-normalised. A list's
  centroid is its centre.

Both take the list of every row as given (the upstream's precomputed
assignments): a row is drawn around its list's centroid.
"""

from __future__ import annotations

import torch

CELLS, BINS = 16, 8
_RING = [2, 1, 1, 2, 1, 0, 0, 1, 1, 0, 0, 1, 2, 1, 1, 2]


class SiftLike:
    """SIFT-like rows, one appearance class per list (d = 128)."""

    d = 128

    def __init__(self, nc: int, g: torch.Generator, sigma: float = 0.75):
        dev = g.device
        self.sigma = float(sigma)
        dom = torch.randint(0, BINS, (nc, 1), generator=g, device=dev)
        wob = torch.randint(-1, 2, (nc, CELLS), generator=g, device=dev)
        ring = torch.tensor(_RING, dtype=torch.float32, device=dev)
        self.dom = ((dom + wob) % BINS).to(torch.int8)
        self.cell_log = (torch.randn((nc, CELLS), generator=g, device=dev)
                         * 0.9 - 0.45 * ring)
        b = torch.arange(BINS, device=dev)
        self.prof = torch.exp(-0.9 * torch.minimum(b, BINS - b).float())

    def _finish(self, v: torch.Tensor) -> torch.Tensor:
        v = torch.where(v < 0.22 * v.amax(dim=2, keepdim=True), 0.0, v)
        v = v.reshape(v.shape[0], self.d)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        v = torch.clamp(v, max=0.2)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        return torch.clamp(torch.floor(v * 512.0), 0.0, 255.0)

    def _energy(self, keys: torch.Tensor) -> torch.Tensor:
        domb = self.dom[keys].long()
        shift = (torch.arange(BINS, device=keys.device)[None, None, :]
                 - domb[:, :, None]) % BINS
        return self.prof[shift] * torch.exp(self.cell_log[keys])[:, :, None]

    def centroids(self) -> torch.Tensor:
        keys = torch.arange(self.dom.shape[0], device=self.dom.device)
        return self._finish(self._energy(keys))

    def rows(self, keys: torch.Tensor, g: torch.Generator) -> torch.Tensor:
        jit = torch.exp(torch.randn((keys.shape[0], CELLS, BINS), generator=g,
                                    device=keys.device) * self.sigma)
        return self._finish(self._energy(keys) * jit)


class DeepLike:
    """DEEP-like rows (d = 96): unit Gaussian centres, one per list."""

    d = 96

    def __init__(self, nc: int, g: torch.Generator, spread: float = 0.35):
        dev = g.device
        c = torch.randn((nc, self.d), generator=g, device=dev)
        self.centres = c / torch.linalg.vector_norm(c, dim=1, keepdim=True)
        self.spectrum = torch.arange(1, self.d + 1, device=dev,
                                     dtype=torch.float32) ** -0.5
        self.mix = (torch.randn((self.d, self.d), generator=g, device=dev)
                    / self.d ** 0.5)
        self.spread = float(spread)

    def centroids(self) -> torch.Tensor:
        return self.centres.clone()

    def rows(self, keys: torch.Tensor, g: torch.Generator) -> torch.Tensor:
        noise = torch.randn((keys.shape[0], self.d), generator=g,
                            device=keys.device)
        v = self.centres[keys] + self.spread * ((noise * self.spectrum)
                                                @ self.mix)
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


LAWS = {"siftlike": SiftLike, "deep": DeepLike}
