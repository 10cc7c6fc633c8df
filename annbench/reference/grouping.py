"""Plain IVFADC + Grouping + Pruning (the upstream's
IndexIVF_HNSW_Grouping): each list split over its nsubc nearest neighbour
centroids, subcentroid s_j = c + alpha (n_j - c) with one alpha per group
(sum of the rows' clamped projections over the sum of |n_j - c|^2 of each
row's best direction), a row coded against its nearest subcentroid, and
the four-term distance

    d = (1 - a)(||q - c||^2 - ||c||^2) + a(||q - n||^2 - ||n||^2)
        + ||y||^2_norm-code - 2 <q R^T, y>_PQ.

Pruning keeps a subgroup when its estimated distance
qsd = (1 - a)||q - c||^2 + a||q - n||^2 - a(1 - a)||c - n||^2 lies below
the mean qsd over the non-empty subgroups of the probes whose groups,
counted before them, hold fewer than 2 * max_codes codes; the max_codes
rule counts kept codes.
"""

from __future__ import annotations

import torch

from annbench.reference.core import (INF, Prec, admitted, clusters,
                                     coarse_top, nearest_with_alt, ranges)
from annbench.reference.ivfadc import (RefIVFADC, reference_answers,
                                       search_gaps)


class RefGrouping(RefIVFADC):
    """Grouping reference. ``nn`` [nc, nsubc] and ``alphas`` [nc] are the
    neighbour lists and group alphas to follow; None computes them here, in
    this reference's precision."""

    def __init__(self, cfg, dep, cb, norms, prec, nn=None, alphas=None):
        super().__init__(cfg, dep, cb, norms, prec)
        self.S = cfg["nsubc"]
        self.nn = (self.neighbors() if nn is None else nn).long()
        V = self.C[self.nn] - self.C[:, None, :]
        self.vn = (V * V).sum(-1)                                  # [nc, S]
        self.alpha = (self.alpha_pass(torch.ones(self.nc, dtype=torch.bool,
                                                 device=self.C.device))[0]
                      if alphas is None else prec.t(alphas))
        n = self.code_b.shape[0]
        dev = self.C.device
        self.subc = torch.zeros(n, dtype=torch.long, device=dev)
        self.size_lo = torch.zeros((self.nc, self.S), dtype=torch.long,
                                   device=dev)
        self.size_hi = torch.zeros_like(self.size_lo)

    def neighbors(self) -> torch.Tensor:
        """Each centroid's nsubc nearest other centroids, ascending; the self
        match dropped, or the farthest when absent."""
        S = self.S
        d, i = coarse_top(self.prec, self.C, self.C, self.cn, S + 1)
        rows = torch.arange(self.nc, device=i.device)[:, None]
        keep = torch.sort((i == rows).to(torch.int8), dim=1,
                          stable=True).indices[:, :S]
        return i.gather(1, keep)

    def _rows_of(self, groups: torch.Tensor):
        """Yield (rows, lists, base positions) of every base row whose list
        is flagged in ``groups`` [nc] bool, chunk by chunk."""
        dep = self.dep
        for i in range(dep.n_chunks()):
            keys = dep.chunk_keys(i)
            sel = groups[keys]
            if not bool(sel.any()):
                continue
            x, _ = dep.chunk(i)
            ids = torch.arange(i * dep.chunk_rows, i * dep.chunk_rows
                               + keys.numel(), device=keys.device)[sel]
            yield x[sel], keys[sel], self.inv[ids]

    def _proj(self, x, keys):
        """(r = x - c [n, d], <n_j - c, r> [n, S], ||r||^2 [n])."""
        r = self.prec.t(x) - self.C[keys]
        V = self.C[self.nn[keys]] - self.C[keys][:, None, :]
        ip = self.prec.mm(V, r[:, :, None])[:, :, 0]
        return r, ip, (r * r).sum(1)

    def alpha_pass(self, groups: torch.Tensor, step: int = 1 << 14):
        """(alphas [nc], slack [nc]) over the rows of the flagged groups:
        each row's direction j* maximises <v_j, r>_+^2 / |v_j|^2 (its
        optimal subcentroid's distance is ||r||^2 minus that; the first j
        among equals), alpha = sum of <v_j*, r>_+ over sum of |v_j*|^2. The
        slack bounds how far alpha moves when a row's best two directions
        lie within the tie band and the other is taken."""
        num = torch.zeros(self.nc, dtype=self.prec.dtype, device=self.C.device)
        den = torch.zeros_like(num)
        dnum = torch.zeros_like(num)
        for x, keys, _ in self._rows_of(groups):
            for s in range(0, x.shape[0], step):
                xs, ks = x[s:s + step], keys[s:s + step]
                _, ip, rn = self._proj(xs, ks)
                nump = ip.clamp_min(0.0)
                vn = self.vn[ks]
                score = nump * nump / vn
                top, j = torch.topk(score, 2, dim=1)
                jb = torch.where(top[:, 0] > 0, j[:, 0], 0)
                a_n, a_d = nump.gather(1, jb[:, None])[:, 0], vn.gather(
                    1, jb[:, None])[:, 0]
                num.index_add_(0, ks, a_n)
                den.index_add_(0, ks, a_d)
                if self.prec.eps > 0:
                    tie = (top[:, 0] - top[:, 1]) <= self.prec.eps * rn
                    b_n = nump.gather(1, j[:, 1:2])[:, 0]
                    b_d = vn.gather(1, j[:, 1:2])[:, 0]
                    dnum.index_add_(0, ks, torch.where(
                        tie, (a_n - b_n).abs() + (a_d - b_d).abs(), 0.0))
        alpha = torch.where(den > 0, num / den.clamp_min(1e-300), 0.0)
        return alpha, dnum / den.clamp_min(1e-300) * (1.0 + alpha)

    def prepare(self, lists: torch.Tensor) -> None:
        need = lists & ~self.ready
        if not bool(need.any()):
            return
        for x, keys, pos in self._rows_of(need):
            for s in range(0, x.shape[0], 1 << 14):
                self._encode_group_rows(x[s:s + (1 << 14)],
                                        keys[s:s + (1 << 14)],
                                        pos[s:s + (1 << 14)])
        self.ready |= need

    def _encode_group_rows(self, x, keys, pos) -> None:
        prec = self.prec
        r, ip, rn = self._proj(x, keys)
        a = self.alpha[keys]
        d = rn[:, None] - 2.0 * a[:, None] * ip + (a * a)[:, None] * self.vn[keys]
        j, j2 = nearest_with_alt(d, rn + (a * a) * self.vn[keys].amax(1),
                                 prec.eps)
        wide = j2 != j
        base = self.C[keys] + a[:, None] * (self.C[self.nn[keys, j]]
                                            - self.C[keys])
        b, alt, lo, hi = self.encode(x, base)
        self.code_b[pos], self.code_a[pos] = b, alt
        self.norm_lo[pos], self.norm_hi[pos] = lo, hi
        self.wide[pos] = wide
        self.subc[pos] = j
        one = torch.ones_like(keys)
        self.size_lo.view(-1).index_add_(0, (keys * self.S + j)[~wide],
                                         one[~wide])
        self.size_hi.view(-1).index_add_(0, keys * self.S + j, one)
        self.size_hi.view(-1).index_add_(0, (keys * self.S + j2)[wide],
                                         one[wide])

    def _need(self, Q: torch.Tensor) -> torch.Tensor:
        P = min(self.cfg["nprobe"], self.nc)
        return coarse_top(self.prec, self.prec.t(Q), self.C, self.cn,
                          min(P + 16, self.nc))[1].reshape(-1)

    def _coarse_sets(self, Q: torch.Tensor):
        cfg, prec = self.cfg, self.prec
        q = prec.t(Q)
        P = min(cfg["nprobe"], self.nc)
        vals, ids = coarse_top(prec, q, self.C, self.cn, min(P + 16, self.nc))
        self.prepare(torch.zeros(self.nc, dtype=torch.bool,
                                 device=ids.device).index_fill_(
                                     0, ids.reshape(-1), True))
        scales = (q * q).sum(1) + self.cn.max()
        start, end = clusters(vals, prec.eps * scales)
        gs = self.sizes[ids]
        thr_loose, thr_tight = admitted(start, end, P, gs, gs,
                                        2 * cfg["max_codes"])
        for b in range(Q.shape[0]):
            yield (q[b], vals[b], ids[b], start[b:b + 1], end[b:b + 1],
                   thr_loose[b], thr_tight[b], scales[b])

    def _query(self, q, vals, g, start, end, thr_loose, thr_tight, scale):
        """One query's probe terms and subgroup sets: (term1 [p], term2
        [p, S], kept for certain / possibly [p, S], loose / tight [p])."""
        cfg, prec = self.cfg, self.prec
        P = min(cfg["nprobe"], self.nc)
        a = self.alpha[g]
        nn = self.nn[g]                                            # [p, S]
        qn = ((q * q).sum() - 2.0 * prec.mm(self.C[nn], q[:, None])[:, :, 0]
              + self.cn[nn])
        t1 = (1 - a) * (vals - self.cn[g])
        t2 = a[:, None] * (qn - self.cn[nn])
        slo, shi = self.size_lo[g], self.size_hi[g]
        if cfg["do_pruning"]:
            qsd = ((1 - a)[:, None] * vals[:, None] + a[:, None] * qn
                   - (a * (1 - a))[:, None] * self.vn[g])
            thr = []
            for st in (thr_loose, thr_tight):
                for ne in (slo > 0, shi > 0):
                    m = st[:, None] & ne
                    thr.append(float(torch.where(m, qsd, 0.0).sum()
                                     / m.sum().clamp_min(1)))
            e = float(prec.eps * scale)
            kc = (slo > 0) & (qsd < min(thr) - e)
            kp = (shi > 0) & (qsd < max(thr) + e)
        else:
            kc, kp = slo > 0, shi > 0
        loose, tight = admitted(start, end, P, (slo * kc).sum(1)[None],
                                (shi * kp).sum(1)[None], cfg["max_codes"])
        return t1, t2, kc, kp, loose[0], tight[0]

    def candidates(self, Q: torch.Tensor):
        out = []
        for q, vals, g, start, end, tl, tt, scale in self._coarse_sets(Q):
            t1, t2, kc, kp, loose, tight = self._query(q, vals, g, start, end,
                                                       tl, tt, scale)
            pi = torch.nonzero(loose)[:, 0]
            cnt = self.sizes[g[pi]]
            pos = ranges(self.offsets[g[pi]], cnt)
            p = torch.repeat_interleave(pi, cnt)
            sc = self.subc[pos]
            w = self.wide[pos]
            inL = kp[p, sc] | w
            inT = tight[p] & kc[p, sc] & ~w
            lo, hi = self.row_bounds(self.lut(q), pos, t1[p] + t2[p, sc])
            out.append((self.order[pos][inL], lo[inL], hi[inL], inT[inL],
                        scale))
        return out

    def work(self, Q: torch.Tensor):
        """Per query of Q: (groups admitted for certain, flat ids g * S + j
        of their subgroups kept for certain)."""
        out = []
        for q, vals, g, start, end, tl, tt, scale in self._coarse_sets(Q):
            _, _, kc, _, _, tight = self._query(q, vals, g, start, end, tl,
                                                tt, scale)
            flat = g[:, None] * self.S + torch.arange(self.S, device=g.device)
            out.append((g[tight], flat[tight[:, None] & kc]))
        return out


def neighbor_gap(prec, C: torch.Tensor, nn: torch.Tensor,
                 block: int = 4096) -> float:
    """How far the farthest of each group's listed neighbours lies beyond
    its nsubc-th nearest other centroid (f64), over the scale
    2 max ||c||^2; +inf when a list holds the group itself or a repeat."""
    C = prec.t(C)
    cn = (C * C).sum(1)
    S = nn.shape[1]
    worst = 0.0
    for s in range(0, C.shape[0], block):
        d = cn[s:s + block, None] - 2.0 * C[s:s + block] @ C.T + cn[None]
        rows = torch.arange(s, min(s + block, C.shape[0]), device=C.device)
        d[torch.arange(rows.numel()), rows] = INF
        kth = torch.topk(d, S, dim=1, largest=False).values[:, -1]
        blk = nn[s:s + block].long()
        if bool((blk == rows[:, None]).any()) or bool(
                (torch.sort(blk, 1).values.diff(dim=1) == 0).any()):
            return INF
        gap = (d.gather(1, blk).amax(1) - kth).clamp_min(0).amax()
        worst = max(worst, float(gap))
    return worst / float(2 * cn.max())


def judge_search(cfg, dep, cb, norms, Qs, D, L, owner, state):
    """(gaps, reference) of the window's answers (``reference.judge``),
    the reference following the program's neighbour lists and alphas
    (``state``), with those checked by themselves over every group:
    ``nn_gap`` and ``alpha_gap``."""
    ref = RefGrouping(cfg, dep, cb, norms, Prec("f64"), state["nn"],
                      state["alphas"])
    ref.prepare_for(Qs)
    out = search_gaps(ref, cfg, Qs, D, L, owner)
    out["nn_gap"] = neighbor_gap(ref.prec, dep.centroids, state["nn"])
    every = torch.ones(ref.nc, dtype=torch.bool, device=ref.C.device)
    alpha, slack = ref.alpha_pass(every)
    dev = (ref.prec.t(state["alphas"]) - alpha).abs()
    out["alpha_gap"] = float((dev - slack).clamp_min(0).amax())
    ref.notes = {"alpha_slack_max": float(slack.amax()),
                 "alpha_slack_groups": int((slack > 0).sum()),
                 "alpha_dev_max": float(dev.amax()),
                 "groups": ref.nc}
    return out, ref


def control_search(cfg, dep, cb, norms, Qs, prec_name: str = "tf32"):
    """The reference's own answers to Qs in ``prec_name``, with its own
    neighbour lists and alphas: (D, L, the state it followed)."""
    ref = RefGrouping(cfg, dep, cb, norms, Prec(prec_name))
    ref.prepare_for(Qs)
    D, L = reference_answers(ref, cfg, Qs)
    return D, L, {"nn": ref.nn, "alphas": ref.alpha.float()}
