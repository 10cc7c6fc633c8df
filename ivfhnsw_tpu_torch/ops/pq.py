"""Product quantizer and 1-byte norm quantizer. Counterpart of
``ivfhnsw_tpu/ops/pq.py`` (faiss ProductQuantizer train / compute_codes /
decode / compute_inner_prod_table, and the reference's 1-byte norm_pq).

All M subspace problems are batched along a leading M axis. ``save`` and
``load`` speak the faiss ``.pq`` layout (``utils/faiss_io.py``), so the
artifacts interchange with the JAX package and the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.kmeans import kmeans_batched
from ivfhnsw_tpu_torch.utils import faiss_io

# Rows encoded per step: bounds the [M, rows, ksub] f32 distance temp to
# 1 GB at M=16 (a 1M-row batch in one step would need 16 GB).
ENCODE_ROWS = 65536


def _pq_encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x [n, d], codebooks [M, ksub, dsub] -> codes [n, M] uint8, encoded in
    pieces of ENCODE_ROWS rows."""
    n, d = x.shape
    M, ksub, dsub = codebooks.shape
    cb_sq = (codebooks * codebooks).sum(-1)                   # [M, ksub]
    out = torch.empty((n, M), dtype=torch.uint8, device=x.device)
    for s in range(0, n, ENCODE_ROWS):
        xs = x[s:s + ENCODE_ROWS].reshape(-1, M, dsub).transpose(0, 1)
        ip = torch.bmm(xs, codebooks.transpose(1, 2))         # [M, r, ksub]
        dists = cb_sq[:, None, :] - 2.0 * ip                  # + ||x||^2 (const)
        out[s:s + ENCODE_ROWS] = dists.argmin(dim=-1).T.to(torch.uint8)
    return out


def _pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes [n, M] uint8 -> [n, d] f32."""
    n, M = codes.shape
    dsub = codebooks.shape[2]
    midx = torch.arange(M, device=codes.device)[None, :]
    return codebooks[midx, codes.long()].reshape(n, M * dsub)


def norm_encode(norms: torch.Tensor,
                centroids: torch.Tensor) -> torch.Tensor:
    """Nearest of the norm quantizer's ``centroids`` [ksub] for each of
    ``norms`` [n] -> codes [n] uint8, in pieces of ENCODE_ROWS rows."""
    out = torch.empty(norms.shape[0], dtype=torch.uint8, device=norms.device)
    for s in range(0, norms.shape[0], ENCODE_ROWS):
        d = (norms[s:s + ENCODE_ROWS, None].float() - centroids[None, :]).abs()
        out[s:s + ENCODE_ROWS] = d.argmin(dim=1).to(torch.uint8)
    return out


def _pq_ip_luts(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product LUTs: q [B, d] -> [B, M, ksub] f32, with
    LUT[b, m, k] = <q_b restricted to subspace m, codebook[m, k]>
    (compute_inner_prod_table, IndexIVF_HNSW.cpp:262)."""
    B, d = q.shape
    M, ksub, dsub = codebooks.shape
    qs = q.reshape(B, M, dsub).transpose(0, 1)                # [M, B, dsub]
    return torch.bmm(qs, codebooks.transpose(1, 2)).transpose(0, 1)


class ProductQuantizer:
    """M-subquantizer, 8-bit product quantizer (ksub=256)."""

    def __init__(self, d: int, M: int, ksub: int = 256):
        if d % M != 0:
            raise ValueError(f"d={d} not divisible by M={M}")
        self.d, self.M, self.ksub = d, M, ksub
        self.dsub = d // M
        self.codebooks: torch.Tensor | None = None  # [M, ksub, dsub]

    def train(self, generator: torch.Generator, data: torch.Tensor,
              niter: int = 25, init: torch.Tensor | None = None):
        """data [n, d] on the device: k-means per subspace, all M batched;
        ``init`` [M, ksub, dsub] warm-starts it from earlier codebooks."""
        n = data.shape[0]
        sub = data.float().reshape(n, self.M, self.dsub).transpose(0, 1)
        self.codebooks = kmeans_batched(generator, sub.contiguous(),
                                        self.ksub, niter=niter, init=init)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return _pq_encode(x.float(), self.codebooks)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return _pq_decode(codes, self.codebooks)

    def ip_luts(self, q: torch.Tensor) -> torch.Tensor:
        return _pq_ip_luts(q.float(), self.codebooks)

    # -- IO: faiss write_ProductQuantizer byte layout; load() also sniffs
    # the JAX package's round-1 legacy header for old caches. --

    def save(self, path: str) -> None:
        faiss_io.write_product_quantizer(path, self.codebooks.cpu().numpy())

    @classmethod
    def load(cls, path: str, device) -> "ProductQuantizer":
        """The quantizer of a ``.pq`` file, its codebooks on ``device``."""
        if faiss_io.is_faiss_pq(path):
            cb = faiss_io.read_product_quantizer(path)
            M, ksub, dsub = cb.shape
            pq = cls(M * dsub, M, ksub)
        else:  # legacy [u32 d | u32 M | u32 ksub | f32 blob]
            with open(path, "rb") as f:
                d, M, ksub = (int(v) for v in np.fromfile(f, "<u4", 3))
                pq = cls(d, M, ksub)
                cb = np.fromfile(f, "<f4",
                                 M * ksub * (d // M)).reshape(M, ksub, d // M)
        pq.codebooks = torch.tensor(cb, device=device)
        return pq


class NormQuantizer:
    """1-byte scalar quantizer for squared L2 norms — the reference's
    norm_pq = faiss::ProductQuantizer(1, 1, 8) (IndexIVF_HNSW.cpp:14,
    decode at :280)."""

    def __init__(self, ksub: int = 256):
        self.ksub = ksub
        self.centroids: torch.Tensor | None = None  # [ksub] f32, ascending

    def train(self, generator: torch.Generator, norms: torch.Tensor,
              niter: int = 25):
        cents = kmeans_batched(generator, norms.float().reshape(1, -1, 1),
                               self.ksub, niter=niter)
        # Sorted so codes are monotone in norm; decode is a gather either way.
        self.centroids = torch.sort(cents.reshape(self.ksub)).values
        return self

    def encode(self, norms: torch.Tensor) -> torch.Tensor:
        return norm_encode(norms, self.centroids)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.centroids[codes.long()]

    def save(self, path: str) -> None:
        """faiss layout: the reference's norm quantizer is a
        ProductQuantizer(1, 1, 8), i.e. d=M=1, nbits=8, 256 centroids."""
        faiss_io.write_product_quantizer(
            path, self.centroids.cpu().numpy().reshape(1, -1, 1))

    @classmethod
    def load(cls, path: str, device) -> "NormQuantizer":
        """The quantizer of a ``.norm_pq`` file, its centroids sorted
        ascending (as ``train`` leaves them) on ``device``."""
        if faiss_io.is_faiss_pq(path):
            cb = faiss_io.read_product_quantizer(path)
            nq = cls(cb.shape[1])
            cents = np.sort(cb.reshape(-1))
        else:  # legacy [u32 ksub | f32 blob], kept in file order
            with open(path, "rb") as f:
                ksub = int(np.fromfile(f, "<u4", 1)[0])
                nq = cls(ksub)
                cents = np.fromfile(f, "<f4", ksub)
        nq.centroids = torch.tensor(cents, device=device)
        return nq
