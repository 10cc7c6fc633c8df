"""Everything a deployment's run is made of, drawn from ``--seed`` on the
device: centroids, each base row's list (the upstream's precomputed
assignments), the base rows in chunks, the held-out query pool, the add
segments, the PQ and norm-PQ codebooks (the benchmark's own plain k-means
on ``nsubt`` rows) and, with OPQ, a random orthogonal rotation. The same
seed gives the same tensors; the program and the reference get the same
ones.

List sizes follow log-normal shares (``list_sigma``): a list's share is
exp(list_sigma * z), z standard normal, so the imbalance factor
E[s^2] / E[s]^2 is about exp(list_sigma^2). The shares, and the base's
list sizes apportioned from them, are the same for every seed (a seed
changes the data and the order of the rows, not the sizes of the work);
queries and add segments draw their lists by the shares.
"""

from __future__ import annotations

import hashlib

import torch

from annbench.gen.kmeans import kmeans_1d, pq_train
from annbench.gen.laws import LAWS


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


class Deployment:
    """The data of configuration ``cfg`` (a configs/*.json dict) for run
    seed ``seed`` on ``device``."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed = cfg, int(seed)
        self.device = torch.device(device)
        self.nb, self.nc, self.d = cfg["nb"], cfg["nc"], cfg["d"]
        self.chunk_rows = cfg["chunk_rows"]
        g = generator(self.device, seed, "law")
        self.law = LAWS[cfg["corpus"]](self.nc, g, **cfg.get("law", {}))
        if self.law.d != self.d:
            raise ValueError(f"corpus {cfg['corpus']} has d={self.law.d}, "
                             f"config says {self.d}")
        self.centroids = self.law.centroids().contiguous()
        w = torch.exp(cfg["list_sigma"] * torch.randn(
            self.nc, generator=generator(self.device, 0, "shares"),
            device=self.device, dtype=torch.float64))
        w = w / w.sum()
        self._cdf = torch.cumsum(w, 0)
        exact = w * self.nb
        sizes = torch.floor(exact).long()
        rest = self.nb - int(sizes.sum())
        sizes[torch.topk(exact - sizes, rest).indices] += 1
        self.sizes = sizes
        self._keys = None
        self.rotation = None
        if cfg["do_opq"]:
            q, r = torch.linalg.qr(torch.randn(
                (self.d, self.d), generator=generator(self.device, seed, "opq"),
                device=self.device, dtype=torch.float64))
            self.rotation = (q * torch.sign(torch.diagonal(r))[None, :]).to(
                torch.float32).contiguous()

    def draw_keys(self, n: int, g: torch.Generator) -> torch.Tensor:
        u = torch.rand(n, generator=g, device=self.device, dtype=torch.float64)
        return torch.searchsorted(self._cdf, u).clamp_max(self.nc - 1)

    def n_chunks(self) -> int:
        return -(-self.nb // self.chunk_rows)

    def chunk_keys(self, i: int) -> torch.Tensor:
        """The lists of base chunk i's rows (cheap: no rows drawn): the
        base's fixed list sizes, laid out in an order drawn from the seed."""
        if self._keys is None:
            keys = torch.repeat_interleave(
                torch.arange(self.nc, device=self.device, dtype=torch.int32),
                self.sizes)
            perm = torch.randperm(self.nb, device=self.device,
                                  generator=generator(self.device, self.seed,
                                                      "order"))
            self._keys = keys[perm]
            del perm
        c = self.chunk_rows
        return self._keys[i * c:(i + 1) * c].long()

    def chunk(self, i: int):
        """(rows [n, d] f32, lists [n] int64) of base chunk i: rows
        i * chunk_rows onwards, ids equal to their row numbers."""
        keys = self.chunk_keys(i)
        x = self.law.rows(keys, generator(self.device, self.seed, f"rows{i}"))
        return x, keys

    def all_keys(self) -> torch.Tensor:
        return torch.cat([self.chunk_keys(i) for i in range(self.n_chunks())])

    def queries(self, n: int) -> torch.Tensor:
        """The held-out query pool [n, d] f32."""
        g = generator(self.device, self.seed, "queries")
        return self.law.rows(self.draw_keys(n, g), g)

    def segment(self, j: int, n: int) -> torch.Tensor:
        """Add segment j [n, d] f32 (lists drawn, then forgotten: the
        program assigns them itself)."""
        g = generator(self.device, self.seed, f"segment{j}")
        return self.law.rows(self.draw_keys(n, g), g)

    def quantizers(self):
        """(codebooks [M, 256, dsub] f32, norm centroids [256] f32 ascending)
        trained by plain k-means on ``nsubt`` rows' residuals against their
        lists' centroids (rotated under OPQ), the norm quantizer on the
        squared norms of their reconstructions."""
        cfg = self.cfg
        g = generator(self.device, self.seed, "train")
        keys = self.draw_keys(cfg["nsubt"], g)
        x = self.law.rows(keys, g)
        base = self.centroids[keys]
        r = x - base
        if self.rotation is not None:
            r = r @ self.rotation.T
        M = cfg["code_size"]
        cb = pq_train(r, M, g, niter=cfg["pq_niter"])
        dsub = self.d // M
        codes = encode_nearest(r, cb)
        dec = cb[torch.arange(M, device=self.device)[None, :],
                 codes].reshape(-1, M * dsub)
        if self.rotation is not None:
            dec = dec @ self.rotation
        recon = dec + base
        norms = kmeans_1d((recon * recon).sum(dim=1), 256, g,
                          niter=cfg["pq_niter"])
        return cb.contiguous(), torch.sort(norms).values.contiguous()


def encode_nearest(r: torch.Tensor, cb: torch.Tensor,
                   step: int = 65536) -> torch.Tensor:
    """Nearest codeword of each subvector: r [n, M*dsub], cb [M, 256, dsub]
    -> [n, M] int64."""
    n = r.shape[0]
    M, _, dsub = cb.shape
    out = torch.empty((n, M), dtype=torch.int64, device=r.device)
    cbn = (cb * cb).sum(-1)
    for s in range(0, n, step):
        rs = r[s:s + step].reshape(-1, M, dsub).transpose(0, 1)
        d = cbn[:, None, :] - 2.0 * torch.bmm(rs, cb.transpose(1, 2))
        out[s:s + step] = d.argmin(dim=-1).T
    return out
