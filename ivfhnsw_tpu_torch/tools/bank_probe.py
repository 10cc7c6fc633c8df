"""The bank probe: the ADC scan kernels timed over three code stores that
differ only in which shared-memory banks their LUT lookups hit.

Run from the root of a checkout (it builds the primary synthetic index, 2M x
128d, nc=4096, code_size=16, and takes one 8192-query batch's schedule):

    python -m ivfhnsw_tpu_torch.tools.bank_probe [-which new,direct,skew]
        [-device cuda] [-nb 2000000] [-batch 8192]

The stores have the shape of the index's own (``codes [N, M]``,
``norm_codes [N]``), and the LUTs and the schedule stay those of the batch,
so bytes, launches and operations are equal across the three:

- ``real``: the index's codes. 32 random codes per warp and row.
- ``free``: ``codes[r, m] = norm_codes[r] = r % 32``. The lanes of a warp
  hold consecutive rows r, so in a row-major LUT (entry k of row m at word
  m*256 + k) their 32 lookups fall in 32 different banks.
- ``way8``: ``codes[r, m] = norm_codes[r] = 32 * (r % 8)``. In a row-major
  LUT all 32 lookups fall in one bank, at 8 different words: replayed 8
  times.

A fourth timing, ``hot``, takes the ``free`` store with every slot of the
schedule moved to row 0: all warps then read the same few rows, so the codes
come from L1 and not from L2. What ``hot`` gains over ``free`` is what the
code reads from L2 cost.

A kernel whose time follows the store (free < real < way8) is bound by
bank conflicts of its lookups; one whose layout keeps the lanes of a warp
in different banks whatever the codes takes the same time on all three.
``new`` are ``adc_scan_slots`` / ``adc_scan_slots_min`` (``csrc/adc_scan.cu``:
a row-major LUT; the wide kernel with streaming stores and one fill per run
of empty slots, writing the bin minima as the search asks of it), ``direct`` the lab's ``direct*`` variants
(``csrc/scan_lab.cu``: those kernels as first ported) and ``skew`` its
``skew*`` variants (a bank-skewed LUT: the lanes of a warp in 32 different
banks). Each
kernel is first held to ``torch.equal`` with its plain version on every
store, then timed (CUDA events, median of 20 after 3 warm-up launches);
the run raises after the last line if a check failed. Also timed: the
staging of the LUT alone (the same kernels on a schedule of one empty slot
per query). Last, where both ``new`` and ``direct`` are probed, each
production kernel against its ``direct`` twin on the real store in turns (A
B B A, four rounds): two kernels a few percent apart are told apart only
so, since the card's state drifts by more than that within a run.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.ops.cuda.adc_scan import CHUNK, RCHUNK
from ivfhnsw_tpu_torch.utils.timer import device_ms, host_ms

STORES = ("real", "free", "way8")


def bank_stores(codes: torch.Tensor, norm_codes: torch.Tensor) -> dict:
    """The three stores of the probe, name -> (codes [N, M] u8, norm_codes
    [N] u8), on the device of ``codes``."""
    N, M = codes.shape
    r = torch.arange(N, device=codes.device)
    free = (r % 32).to(torch.uint8)
    way8 = (32 * (r % 8)).to(torch.uint8)
    return {"real": (codes, norm_codes),
            "free": (free[:, None].repeat(1, M).contiguous(), free),
            "way8": (way8[:, None].repeat(1, M).contiguous(), way8)}


WHICH = ("new", "direct", "skew")


def probe_kernels(gran: int, which=WHICH) -> list:
    """(name, fn(args), plain(args)) of the probed kernels at slot width
    ``gran``; ``args`` are the seven scan inputs."""
    out = []
    if "new" in which:
        out += [(f"adc_scan_slots_gran{gran}",
                 lambda a: tk.adc_scan_slots(*a, gran, bins=True)[0],
                 lambda a: tk.adc_scan_slots_plain(*a, gran)),
                (f"adc_scan_slots_min_gran{gran}",
                 lambda a: tk.adc_scan_slots_min(*a, gran),
                 lambda a: tk.adc_scan_slots_min_plain(*a, gran))]
    for kind in ("direct", "skew"):
        if kind in which:
            for name in (f"{kind}{gran}", f"{kind}{gran}_min"):
                v = sl.VARIANTS[name]
                out.append((f"lab_{name}",
                            lambda a, v=v: sl.FUNCTIONS[v.kind][0](*a, v),
                            lambda a, v=v: sl.scan_full_plain(*a, v)))
    return out


def run(index, queries: np.ndarray, params, device, batch: int = 8192,
        which=WHICH, reps: int = 20, log=print) -> list:
    """Every probed kernel over the three stores (and the ``hot`` case) on
    the schedule of ``queries[:batch]`` at both slot widths; one record and
    one line per kernel. Raises after the last line if a kernel differed
    from its plain version on any of them."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    timer = device_ms if on_card else host_ms
    q = torch.tensor(np.asarray(queries[:batch], np.float32), device=device)
    records, bad = [], []
    for gran in (CHUNK, RCHUNK):
        args = index.scan_inputs(q, params, gran)
        stores = bank_stores(args[2], args[3])
        B, S = args[4].shape
        empty = (args[4][:, :1] * 0, args[5][:, :1] * 0, args[6][:, :1] * 0)
        for name, fn, plain in probe_kernels(gran, which):
            ms, equal = {}, {}
            cases = {store: (*args[:2], *stores[store], *args[4:])
                     for store in STORES}
            cases["hot"] = (*args[:2], *stores["free"],
                            torch.zeros_like(args[4]), *args[5:])
            for case, a in cases.items():
                equal[case] = bool(torch.equal(fn(a), plain(a)))
                ms[case] = timer(lambda: fn(a), reps=reps)
            staging = timer(lambda: fn((*args[:4], *empty)), reps=reps)
            rec = {"name": name, "gran": gran, "B": B, "slots": S,
                   "ms": ms, "equal_plain": equal,
                   "free_over_real": ms["free"] / ms["real"],
                   "way8_over_real": ms["way8"] / ms["real"],
                   "staging_ms": staging,
                   "timer": "cuda_events" if on_card else "host"}
            records.append(rec)
            if not all(equal.values()):
                bad.append(name)
            log(f"[banks] {name:<30} B={B} slots={S}: real "
                f"{ms['real']:.4f} ms, free {ms['free']:.4f} "
                f"({rec['free_over_real']:.2f}x), way8 {ms['way8']:.4f} "
                f"({rec['way8_over_real']:.2f}x), free from row 0 (hot) "
                f"{ms['hot']:.4f}; staging alone "
                f"{staging:.4f} ms; torch.equal to plain on "
                f"{[c for c in cases if equal[c]]}"
                + ("" if on_card else " [host]"))
        if "new" in which and "direct" in which:
            ks = {name: fn for name, fn, _ in probe_kernels(gran, which)}
            real = (*args[:2], *stores["real"], *args[4:])
            for new, old in ((f"adc_scan_slots_gran{gran}",
                              f"lab_direct{gran}"),
                             (f"adc_scan_slots_min_gran{gran}",
                              f"lab_direct{gran}_min")):
                t = {new: [], old: []}
                for name in (new, old, old, new) * 4:
                    t[name].append(timer(lambda: ks[name](real), reps=reps))
                med = {k: statistics.median(v) for k, v in t.items()}
                records.append({"name": f"{new}_vs_{old}", "gran": gran,
                                "ms_in_turns": t, "median_ms": med})
                log(f"[banks] in turns, real store: {new} {med[new]:.4f} ms "
                    f"(of {min(t[new]):.4f}-{max(t[new]):.4f}), {old} "
                    f"{med[old]:.4f} ms (of {min(t[old]):.4f}-"
                    f"{max(t[old]):.4f}): {med[new] / med[old]:.3f}x")
    if bad:
        raise AssertionError(f"bank probe: kernels differ from their plain "
                             f"versions: {bad}")
    return records


def primary_index(device, nb: int = 2_000_000, nq: int = 8192):
    """The primary synthetic index (128d, nc=4096, code_size=16, seed 0)
    over ``nb`` vectors on ``device``, built through ``drivers/common.py``;
    returns (index, queries [nq, 128], search parameters)."""
    from ivfhnsw_tpu_torch import IVFADCIndex
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.utils.config import (IndexConfig, RunConfig,
                                                SearchParams)
    cfg = RunConfig()
    cfg.index = IndexConfig(d=128, nc=4096, code_size=16)
    cfg.search = SearchParams(k=10, nprobe=32, max_codes=10000)
    cfg.nb, cfg.nt, cfg.nq = nb, 200_000, nq
    ds = C.SyntheticDataset(cfg, 0, device)
    index = IVFADCIndex(cfg.index, device)
    gen = torch.Generator(device=device).manual_seed(0)
    C.setup_quantizer(index, cfg, ds, gen)
    C.setup_pq(index, cfg, ds, gen)
    C.build_or_read_index(index, cfg, ds, C.load_or_assign(index, cfg, ds))
    return index, ds.queries, cfg.search


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"which": ",".join(WHICH), "device": "cuda", "nb": "2000000",
            "batch": "8192"}
    while argv:
        flag = argv.pop(0)
        if not flag.startswith("-") or flag[1:] not in opts or not argv:
            raise SystemExit(__doc__)
        opts[flag[1:]] = argv.pop(0)
    device = torch.device(opts["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {opts['device']}: no CUDA device is "
                           "available; pass -device cpu to run on the CPU")
    index, queries, params = primary_index(device, int(opts["nb"]),
                                           int(opts["batch"]))
    records = run(index, queries, params, device, batch=int(opts["batch"]),
                  which=tuple(opts["which"].split(",")),
                  reps=20 if device.type == "cuda" else 2)
    print(json.dumps({"banks": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
