"""IVFADC end-to-end build + eval driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/ivfadc_eval.py`` (the reference's test_ivfhnsw_sift1b
/ test_ivfhnsw_deep1b), on the synthetic corpus.

Usage (reference ``-flag value`` grammar, plus -synthetic and -device,
which defaults to cuda; -device cpu runs the kernels' plain versions):
    python -m ivfhnsw_tpu_torch.drivers.ivfadc_eval -synthetic 0 \\
        -d 128 -nc 4096 -code_size 16 -nb 2000000 -nt 200000 -nq 8192 \\
        -nprobe 32 -max_codes 10000 -k 10
"""

from __future__ import annotations

import torch

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex


def build(cfg, extras):
    """The build stages of the IVFADC drivers; returns (index, dataset)."""
    device, ds = C.synthetic_setup(cfg, extras)
    index = IVFADCIndex(cfg.index, device)
    gen = torch.Generator(device=device).manual_seed(0)
    C.setup_quantizer(index, cfg, ds, gen)
    C.setup_pq(index, cfg, ds, gen)
    idxs = C.load_or_assign(index, cfg, ds)
    C.build_or_read_index(index, cfg, ds, idxs)
    return index, ds


def main(argv=None) -> dict:
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    index, ds = build(cfg, extras)
    return C.eval_search(index, cfg, ds)


if __name__ == "__main__":
    main()
