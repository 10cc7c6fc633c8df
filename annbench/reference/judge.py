"""The comparisons that decide ``correct``: the program's answers from the
timed window against the float64 reference, and the control (the
reference in the program's place at TF32).

Search cells compare, for a sample of the query set drawn from the seed,
every answer the window returned for those queries: ``rank_gap`` and
``label_gap`` (scale-relative, see ``reference.ivfadc.judge_query``) and
``foreign`` (count). Grouping cells also check the derived state the
reference follows, over every group (``nn_gap``, ``alpha_gap``). Add cells
compare a sample of the rows the window added, found in the finalized
store by id:
``add_gap`` (how far a row's list, PQ codes or norm code lie from the
nearest choice, scale-relative) and ``missing`` (ids not found exactly
once).
"""

from __future__ import annotations

import torch

from annbench.reference.core import INF, Prec, coarse_top
from annbench.reference.grouping import RefGrouping, neighbor_gap
from annbench.reference.ivfadc import RefIVFADC, judge_query


def make_ref(cfg, dep, cb, norms, prec: Prec, state: dict | None = None):
    if cfg["index"] == "grouping":
        state = state or {}
        return RefGrouping(cfg, dep, cb, norms, prec, state.get("nn"),
                           state.get("alphas"))
    return RefIVFADC(cfg, dep, cb, norms, prec)


def judge_search(cfg, dep, cb, norms, Qs, D, L, owner, state,
                 block: int = 32) -> dict:
    """(gaps, reference) of the answers D, L [n, k] (answer i belongs to
    sample query owner[i]) to the sample queries Qs [m, d]."""
    ref = make_ref(cfg, dep, cb, norms, Prec("f64"), state)
    ref.prepare_for(Qs)
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
    if cfg["index"] == "grouping":
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


def control_search(cfg, dep, cb, norms, Qs, prec_name: str = "tf32",
                   block: int = 32):
    """The reference's own answers to Qs in ``prec_name`` (no ties kept):
    (D, L, the derived state it followed)."""
    ref = make_ref(cfg, dep, cb, norms, Prec(prec_name))
    ref.prepare_for(Qs)
    D, L = [], []
    for s in range(0, Qs.shape[0], block):
        d, l = ref.answer(Qs[s:s + block], cfg["k"])
        D.append(d)
        L.append(l)
    state = ({"nn": ref.nn, "alphas": ref.alpha.float()}
             if cfg["index"] == "grouping" else {})
    return torch.cat(D).float(), torch.cat(L), state


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


def worst(v: float) -> float:
    """A reading as printed: +inf as 1e30 (JSON has no infinity)."""
    return 1e30 if v == INF or v != v else v
