"""Product quantizer and 1-byte norm quantizer. Counterpart of
``ivfhnsw_tpu/ops/pq.py`` (faiss ProductQuantizer train / compute_codes /
decode / compute_inner_prod_table, and the reference's 1-byte norm_pq).

All M subspace problems are batched along a leading M axis. File IO (the
faiss ``.pq`` layout) is not ported yet.
"""

from __future__ import annotations

import torch

from ivfhnsw_tpu_torch.ops.kmeans import kmeans_batched

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
        out = torch.empty(norms.shape[0], dtype=torch.uint8,
                          device=norms.device)
        for s in range(0, norms.shape[0], ENCODE_ROWS):
            d = (norms[s:s + ENCODE_ROWS, None].float()
                 - self.centroids[None, :]).abs()
            out[s:s + ENCODE_ROWS] = d.argmin(dim=1).to(torch.uint8)
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.centroids[codes.long()]
