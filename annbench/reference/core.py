"""Plain PyTorch reference of IVFADC search and build, independent of the
program: the same operations on the benchmark's data, in a stated
precision.

- ``Prec("f64")`` is the judge. Where the program's float32 arithmetic
  could decide a choice either way (a coarse distance, a PQ or norm
  codeword, a budget or pruning boundary within ``eps`` of the other
  side), it keeps both outcomes: a row's distance becomes an interval
  [lo, hi], a list or subgroup is admitted in the loose set L but not the
  tight set T.
- ``Prec("f32")`` / ``Prec("tf32")`` with eps 0 answer as a plain search
  would: the reference put in the program's place. "tf32" rounds every
  matmul input to TF32's 10-bit mantissa (as the H100's TF32 tensor cores
  do), the control of the configurations' float32 with TF32 off.
"""

from __future__ import annotations

import torch

INF = float("inf")
# Tie band of the judge, relative to the magnitude of the terms a float32
# program sums: about 100 float32 roundings of the largest term.
EPS_F64 = 1e-5


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Prec:
    """Arithmetic of one reference: dtype, matmul and tie band."""

    def __init__(self, name: str):
        if name not in ("f64", "f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32
        self.eps = EPS_F64 if name == "f64" else 0.0

    def t(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)


def coarse_top(prec: Prec, q: torch.Tensor, C: torch.Tensor,
               cn: torch.Tensor, n: int, block: int = 1 << 16,
               rows: int = 2048):
    """The n nearest centroids of each query, ascending: (dists [b, n],
    ids [b, n] int64), squared L2 in matmul form in ``prec``; ``rows``
    queries and ``block`` centroids at a time."""
    if q.shape[0] > rows:
        parts = [coarse_top(prec, q[s:s + rows], C, cn, n, block, rows)
                 for s in range(0, q.shape[0], rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    qn = (q * q).sum(1)
    best_d = best_i = None
    for s in range(0, C.shape[0], block):
        d = qn[:, None] - 2.0 * prec.mm(q, C[s:s + block].T) + cn[None, s:s + block]
        v, i = torch.topk(d, min(n, d.shape[1]), dim=1, largest=False)
        i = i + s
        if best_d is not None:
            v, j = torch.topk(torch.cat([best_d, v], 1), n, dim=1,
                              largest=False)
            i = torch.gather(torch.cat([best_i, i], 1), 1, j)
        best_d, best_i = v, i
    return best_d, best_i


def clusters(vals: torch.Tensor, eps_abs: torch.Tensor):
    """Tie clusters of ascending rows ``vals`` [b, n]: maximal runs whose
    neighbours lie within eps_abs [b] of each other. Returns (start, end)
    [b, n]: each position's cluster's first and last index."""
    b, n = vals.shape
    pos = torch.arange(n, device=vals.device).expand(b, n)
    new = torch.ones((b, n), dtype=torch.bool, device=vals.device)
    new[:, 1:] = (vals[:, 1:] - vals[:, :-1]) > eps_abs[:, None]
    cid = torch.cumsum(new.long(), 1) - 1
    start = torch.zeros((b, n), dtype=torch.long, device=vals.device
                        ).scatter_reduce(1, cid, pos, "amin", include_self=False)
    end = torch.zeros((b, n), dtype=torch.long, device=vals.device
                      ).scatter_reduce(1, cid, pos, "amax", include_self=False)
    return torch.gather(start, 1, cid), torch.gather(end, 1, cid)


def admitted(start, end, nprobe: int, lo_sizes, hi_sizes, budget: int):
    """(loose, tight) [b, n] bool: positions a probe list of ``nprobe``
    taken in some / every order consistent with the tie clusters, that the
    budget rule (the codes of the probes before it number fewer than
    ``budget``; no rule when budget <= 0) admits. lo_sizes / hi_sizes
    [b, n] bound each position's count from below / above."""
    cum_lo = torch.cumsum(lo_sizes, 1)
    cum_hi = torch.cumsum(hi_sizes, 1)
    zero = torch.zeros_like(cum_lo[:, :1])
    before_lo = torch.gather(torch.cat([zero, cum_lo], 1), 1, start)
    worst = torch.gather(cum_hi, 1, end) - hi_sizes
    open_ = budget <= 0
    loose = (start < nprobe) & (open_ | (before_lo < budget))
    tight = (end < nprobe) & (open_ | (worst < budget))
    return loose, tight


def ranges(starts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Concatenation of arange(starts[i], starts[i] + counts[i])."""
    counts = counts.long()
    tot = int(counts.sum())
    if tot == 0:
        return torch.zeros(0, dtype=torch.long, device=starts.device)
    first = torch.cumsum(counts, 0) - counts
    rep = torch.repeat_interleave(torch.arange(counts.numel(),
                                               device=starts.device), counts)
    return starts.long()[rep] + torch.arange(tot, device=starts.device) - first[rep]


def nearest_with_alt(d: torch.Tensor, scale: torch.Tensor, eps: float):
    """Index of the smallest of d [..., K] along the last axis, and the
    second smallest where it lies within eps * scale of it (else the
    smallest again)."""
    v, i = torch.topk(d, 2, dim=-1, largest=False)
    tie = (v[..., 1] - v[..., 0]) <= eps * scale
    return i[..., 0], torch.where(tie, i[..., 1], i[..., 0])


def sorted_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest of 1-D x ascending, padded with +inf."""
    if x.numel() < k:
        x = torch.cat([x, torch.full((k - x.numel(),), INF, dtype=x.dtype,
                                     device=x.device)])
    return torch.topk(x, k, largest=False).values
