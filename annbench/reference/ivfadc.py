"""Plain IVFADC (the upstream's IndexIVF_HNSW with an exact coarse
quantizer): residual PQ codes and a 1-byte norm code per row, lists by
precomputed assignment, search by the nprobe nearest lists under the
max_codes rule (a list is scanned whole when the codes of the lists before
it number fewer than max_codes), distance

    d(q, y) = (||q - c||^2 - ||c||^2) + ||y||^2_norm-code - 2 <q, y - c>_PQ

which is ||q - y||^2 for y = c + the decoded residual. Under OPQ the
residual is rotated by R before PQ and the query before its tables.
"""

from __future__ import annotations

import torch

from annbench.reference.core import (INF, Prec, admitted, clusters,
                                     coarse_top, nearest_with_alt, ranges,
                                     sorted_k)

EXTRA = 16  # coarse positions kept past nprobe for tie clusters


class RefIVFADC:
    """Reference of configuration ``cfg`` over deployment ``dep`` with
    codebooks ``cb`` and norm centroids ``norms``, in precision ``prec``."""

    def __init__(self, cfg: dict, dep, cb, norms, prec: Prec,
                 with_base: bool = True):
        self.cfg, self.dep, self.prec = cfg, dep, prec
        t = prec.t
        self.C = t(dep.centroids)
        self.cn = (self.C * self.C).sum(1)
        self.cb = t(cb)
        self.cbn = (self.cb * self.cb).sum(-1)                # [M, 256]
        self.ntab = t(norms)
        self.R = None if dep.rotation is None else t(dep.rotation)
        self.M = self.cb.shape[0]
        self.nc = dep.nc
        if with_base:
            keys = dep.all_keys()
            self.sizes = torch.bincount(keys, minlength=self.nc)
            self.offsets = torch.cumsum(self.sizes, 0) - self.sizes
            self.order = torch.sort(keys, stable=True).indices  # pos -> id
            self.inv = torch.empty_like(self.order)
            self.inv[self.order] = torch.arange(keys.numel(),
                                                device=keys.device)
            del keys
            self.ready = torch.zeros(self.nc, dtype=torch.bool,
                                     device=self.C.device)
            self._alloc(int(self.sizes.sum()))

    # -- encoding -----------------------------------------------------------

    def _alloc(self, n: int) -> None:
        dev = self.C.device
        self.code_b = torch.zeros((n, self.M), dtype=torch.uint8, device=dev)
        self.code_a = torch.zeros((n, self.M), dtype=torch.uint8, device=dev)
        self.norm_lo = torch.zeros(n, dtype=self.prec.dtype, device=dev)
        self.norm_hi = torch.zeros(n, dtype=self.prec.dtype, device=dev)
        self.wide = torch.zeros(n, dtype=torch.bool, device=dev)

    def rotate(self, r: torch.Tensor) -> torch.Tensor:
        return r if self.R is None else self.prec.mm(r, self.R.T)

    def encode(self, x: torch.Tensor, base: torch.Tensor):
        """Codes of rows x against ``base`` [n, d]: (best codes [n, M],
        alternative codes [n, M] (= best unless within the tie band), norm
        term bounds lo, hi [n])."""
        prec, M = self.prec, self.M
        r = self.rotate(prec.t(x) - base)
        n, d = r.shape
        rs = r.reshape(n, M, d // M).transpose(0, 1)             # [M, n, s]
        rn = (rs * rs).sum(-1)                                     # [M, n]
        dist = (rn[:, :, None] + self.cbn[:, None, :]
                - 2.0 * prec.mm(rs, self.cb.transpose(1, 2)))
        best, alt = nearest_with_alt(dist, rn + self.cbn.amax(1)[:, None],
                                     prec.eps)
        best, alt = best.T.contiguous(), alt.T.contiguous()       # [n, M]
        lo = hi = None
        for codes in ((best, alt) if prec.eps > 0 else (best,)):
            nrm = self._recon_norm(codes, base)
            nb, na = nearest_with_alt((nrm[:, None] - self.ntab[None]).abs(),
                                      nrm.abs(), prec.eps)
            for v in (self.ntab[nb], self.ntab[na]):
                lo = v if lo is None else torch.minimum(lo, v)
                hi = v if hi is None else torch.maximum(hi, v)
        return best.to(torch.uint8), alt.to(torch.uint8), lo, hi

    def _recon_norm(self, codes: torch.Tensor, base: torch.Tensor):
        n = codes.shape[0]
        dec = self.cb[torch.arange(self.M, device=codes.device)[None, :],
                      codes].reshape(n, -1)
        if self.R is not None:
            dec = self.prec.mm(dec, self.R)
        recon = dec + base
        return (recon * recon).sum(1)

    def prepare(self, lists: torch.Tensor) -> None:
        """Encode every base row of the lists flagged in ``lists`` [nc]
        bool that are not encoded yet (the base regenerated chunk by chunk
        from the seed)."""
        need = lists & ~self.ready
        if not bool(need.any()):
            return
        dep = self.dep
        for i in range(dep.n_chunks()):
            keys = dep.chunk_keys(i)
            sel = need[keys]
            if not bool(sel.any()):
                continue
            x, _ = dep.chunk(i)
            ids = torch.arange(i * dep.chunk_rows, i * dep.chunk_rows
                               + keys.numel(), device=keys.device)[sel]
            self._encode_rows(x[sel], keys[sel], self.inv[ids])
            del x
        self.ready |= need

    def _encode_rows(self, x, keys, pos, step: int = 1 << 16) -> None:
        for s in range(0, x.shape[0], step):
            xs, ks, ps = x[s:s + step], keys[s:s + step], pos[s:s + step]
            b, a, lo, hi = self.encode(xs, self.C[ks])
            self.code_b[ps], self.code_a[ps] = b, a
            self.norm_lo[ps], self.norm_hi[ps] = lo, hi

    # -- search -------------------------------------------------------------

    def _need(self, Q: torch.Tensor) -> torch.Tensor:
        """Lists whose rows the candidates of queries Q read."""
        _, ids, loose, _ = self.coarse(Q)
        return ids[loose]

    def prepare_for(self, Q: torch.Tensor, block: int = 256) -> None:
        """Encode, in one pass over the base, every list that the
        candidates of the queries Q read."""
        need = torch.zeros(self.nc, dtype=torch.bool, device=self.C.device)
        for s in range(0, Q.shape[0], block):
            need[self._need(Q[s:s + block])] = True
        self.prepare(need)

    def coarse(self, Q: torch.Tensor):
        """(qc dists, probe ids, loose, tight) [b, nprobe + EXTRA] of the
        queries Q (rows of the list-size budget rule, tie clusters of the
        judge kept)."""
        cfg, prec = self.cfg, self.prec
        q = prec.t(Q)
        P = min(cfg["nprobe"], self.nc)
        vals, ids = coarse_top(prec, q, self.C, self.cn,
                               min(P + EXTRA, self.nc))
        scale = (q * q).sum(1) + self.cn.max()
        start, end = clusters(vals, prec.eps * scale)
        s = self.sizes[ids]
        loose, tight = admitted(start, end, P, s, s, cfg["max_codes"])
        return vals, ids, loose, tight

    def lut(self, q: torch.Tensor) -> torch.Tensor:
        """[M, 256] -2 <q_m, codeword> of one query (rotated under OPQ)."""
        qr = self.rotate(q[None])[0]
        qs = qr.reshape(self.M, 1, -1)
        return -2.0 * self.prec.mm(qs, self.cb.transpose(1, 2))[:, 0, :]

    def row_bounds(self, lut, pos, bias):
        """(lo, hi) distances of rows ``pos`` whose list term is ``bias``."""
        m = torch.arange(self.M, device=pos.device)
        a = lut[m[None, :], self.code_b[pos].long()]
        b = lut[m[None, :], self.code_a[pos].long()]
        lo = bias + self.norm_lo[pos] + torch.minimum(a, b).sum(1)
        hi = bias + self.norm_hi[pos] + torch.maximum(a, b).sum(1)
        w = self.wide[pos]
        return (torch.where(w, -INF, lo), torch.where(w, INF, hi))

    def candidates(self, Q: torch.Tensor):
        """Per query of Q: (ids [n], lo [n], hi [n], in_T [n] bool, scale)
        of the rows of its loose set, and prepares the lists first."""
        vals, ids, loose, tight = self.coarse(Q)
        self.prepare(torch.zeros(self.nc, dtype=torch.bool,
                                 device=ids.device).index_fill_(
                                     0, ids[loose], True))
        q = self.prec.t(Q)
        scales = (q * q).sum(1) + self.cn.max()
        out = []
        for b in range(Q.shape[0]):
            lists, lt = ids[b][loose[b]], tight[b][loose[b]]
            bias = vals[b][loose[b]] - self.cn[lists]
            cnt = self.sizes[lists]
            pos = ranges(self.offsets[lists], cnt)
            lo, hi = self.row_bounds(self.lut(q[b]), pos,
                                     torch.repeat_interleave(bias, cnt))
            out.append((self.order[pos], lo, hi,
                        torch.repeat_interleave(lt, cnt), scales[b]))
        return out

    def work(self, Q: torch.Tensor):
        """Per query of Q: the lists admitted for certain."""
        _, ids, _, tight = self.coarse(Q)
        return [ids[b][tight[b]] for b in range(Q.shape[0])]

    def answer(self, Q: torch.Tensor, k: int):
        """The reference's own search of Q: (dists [b, k], labels [b, k])."""
        D, L = [], []
        for ids, lo, _, _, _ in self.candidates(Q):
            v, j = torch.topk(torch.cat([lo, torch.full(
                (k,), INF, dtype=lo.dtype, device=lo.device)]), k,
                largest=False)
            lab = torch.cat([ids, torch.full((k,), -1, dtype=ids.dtype,
                                             device=ids.device)])[j]
            D.append(v)
            L.append(torch.where(torch.isfinite(v), lab, -1))
        return torch.stack(D), torch.stack(L)


def judge_query(cand, D: torch.Tensor, L: torch.Tensor, k: int):
    """Gaps of one query's answers D, L [occ, k] (ascending distances,
    labels) against its candidates: (rank gap, label gap, foreign labels).

    rank gap: how far the j-th distance lies outside [j-th smallest lo over
    L, j-th smallest hi over T]; label gap: how far a label's distance lies
    outside its own row's [lo, hi]; both over the scale. Foreign: labels
    outside L, repeated in an answer, or -1 beside a finite distance."""
    ids, lo, hi, inT, scale = cand
    D = D.to(lo.dtype)
    LO = sorted_k(lo, k)
    HI = sorted_k(hi[inT], k)
    below = torch.where(torch.isfinite(LO), LO - D, 0.0)
    above = torch.where(torch.isinf(D) & torch.isinf(HI), 0.0, D - HI)
    rank = torch.clamp(torch.maximum(below, above), min=0.0).amax()
    if ids.numel():
        order = torch.argsort(ids)
        sid = ids[order]
        j = torch.searchsorted(sid, L.clamp_min(0)).clamp_max(sid.numel() - 1)
        found = (L >= 0) & (sid[j] == L)
        r = order[j]
        lgap = torch.where(found, torch.clamp(torch.maximum(lo[r] - D, D - hi[r]),
                                              min=0.0), 0.0).amax()
    else:
        found = torch.zeros_like(L, dtype=torch.bool)
        lgap = torch.zeros((), dtype=lo.dtype, device=lo.device)
    srt = torch.sort(L, dim=1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
    foreign = (((L >= 0) & ~found).sum() + dup
               + ((L < 0) & torch.isfinite(D)).sum()
               + ((L >= 0) & torch.isinf(D)).sum())
    return float(rank / scale), float(lgap / scale), int(foreign)


def search_gaps(ref, cfg, Qs, D, L, owner, block: int = 32) -> dict:
    """``rank_gap``, ``label_gap`` and ``foreign`` of the answers D, L [n,
    k] (answer i belongs to sample query owner[i]) to the sample queries
    Qs [m, d], against the candidates of the prepared reference ``ref``."""
    k = cfg["k"]
    out = {"rank_gap": 0.0, "label_gap": 0.0, "foreign": 0}
    order = torch.argsort(owner, stable=True)
    D, L, owner = D[order], L[order], owner[order]
    bounds = torch.searchsorted(owner, torch.arange(
        Qs.shape[0] + 1, device=owner.device))
    for s in range(0, Qs.shape[0], block):
        for i, cand in enumerate(ref.candidates(Qs[s:s + block])):
            a, b = int(bounds[s + i]), int(bounds[s + i + 1])
            if a == b:
                continue
            r, lg, f = judge_query(cand, D[a:b], L[a:b], k)
            out["rank_gap"] = max(out["rank_gap"], r)
            out["label_gap"] = max(out["label_gap"], lg)
            out["foreign"] += f
    return out


def reference_answers(ref, cfg, Qs, block: int = 32):
    """The prepared reference ``ref``'s own answers to Qs (no ties kept):
    (D [m, k] f32, L [m, k])."""
    D, L = [], []
    for s in range(0, Qs.shape[0], block):
        d, l = ref.answer(Qs[s:s + block], cfg["k"])
        D.append(d)
        L.append(l)
    return torch.cat(D).float(), torch.cat(L)


def judge_search(cfg, dep, cb, norms, Qs, D, L, owner, state):
    """(gaps, reference) of the window's answers (``reference.judge``)."""
    ref = RefIVFADC(cfg, dep, cb, norms, Prec("f64"))
    ref.prepare_for(Qs)
    return search_gaps(ref, cfg, Qs, D, L, owner), ref


def control_search(cfg, dep, cb, norms, Qs, prec_name: str = "tf32"):
    """The reference's own answers to Qs in ``prec_name``: (D, L, {})."""
    ref = RefIVFADC(cfg, dep, cb, norms, Prec(prec_name))
    ref.prepare_for(Qs)
    return (*reference_answers(ref, cfg, Qs), {})


def judge_add(cfg, dep, cb, norms, x, keys, codes, norm_codes,
              missing: int, step: int = 4096) -> dict:
    """Gaps of the stored list ``keys``, PQ ``codes`` and ``norm_codes`` of
    sample rows x [n, d] to the nearest choices (f64): the list's distance
    over the nearest centroid's, each subvector's codeword's distance over
    the nearest codeword's, the norm code's distance to the reconstruction's
    squared norm over the nearest norm centroid's, each relative to the
    magnitude of the terms."""
    ref = RefIVFADC(cfg, dep, cb, norms, Prec("f64"), with_base=False)
    prec, M = ref.prec, ref.M
    gap = 0.0
    for s in range(0, x.shape[0], step):
        xs = prec.t(x[s:s + step])
        dmin = coarse_top(prec, xs, ref.C, ref.cn, 1)[0][:, 0]
        ck = ref.C[keys[s:s + step]]
        dk = ((xs - ck) ** 2).sum(1)
        key_gap = (dk - dmin) / ((xs * xs).sum(1) + ref.cn.max())
        r = ref.rotate(xs - ck)
        n, d = r.shape
        rs = r.reshape(n, M, d // M)
        dist = ((rs[:, :, None, :] - ref.cb[None]) ** 2).sum(-1)   # [n, M, K]
        dc = dist.gather(2, codes[s:s + step].long()[:, :, None])[:, :, 0]
        scale = (rs * rs).sum(-1) + ref.cbn.amax(1)[None]
        code_gap = ((dc - dist.amin(2)) / scale).amax(1)
        nrm = ref._recon_norm(codes[s:s + step].long(), ck)
        dn = (nrm[:, None] - ref.ntab[None]).abs()
        norm_gap = ((dn.gather(1, norm_codes[s:s + step].long()[:, None])[:, 0]
                     - dn.amin(1)) / nrm.abs().clamp_min(1e-30))
        gap = max(gap, float(torch.stack([key_gap, code_gap, norm_gap]
                                         ).clamp_min(0).amax()))
    return {"add_gap": gap, "missing": int(missing)}


def control_add(cfg, dep, cb, norms, x, prec_name: str = "tf32"):
    """The reference's own (keys, codes, norm codes) of rows x."""
    ref = RefIVFADC(cfg, dep, cb, norms, Prec(prec_name), with_base=False)
    keys = coarse_top(ref.prec, ref.prec.t(x), ref.C, ref.cn, 1)[1][:, 0]
    b, _, lo, _ = ref.encode(x, ref.C[keys])
    ncode = (lo[:, None] - ref.ntab[None]).abs().argmin(1)
    return keys, b, ncode
