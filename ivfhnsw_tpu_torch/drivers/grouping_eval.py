"""Grouping(+Pruning) end-to-end build + eval driver on PyTorch. Counterpart
of ``ivfhnsw_tpu/drivers/grouping_eval.py`` (the reference's
test_ivfhnsw_grouping_sift1b / test_ivfhnsw_grouping_deep1b), on the
synthetic corpus: centroids, neighbour centroids, [OPQ +] PQ on subcentroid
residuals, assignment, the alpha pass, the add loop, the direct
inter-centroid distances, then the timed query loop with optional pruning.

Usage (reference ``-flag value`` grammar, plus -synthetic and -device,
which defaults to cuda; -device cpu runs the kernels' plain versions):
    python -m ivfhnsw_tpu_torch.drivers.grouping_eval -synthetic 0 \\
        -nsubc 64 -do_opq on -do_pruning on \\
        -d 128 -nc 4096 -code_size 16 -nb 2000000 -nt 200000 -nq 8192 \\
        -nprobe 32 -max_codes 10000 -k 10
"""

from __future__ import annotations

import torch

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex


def build(cfg, extras):
    """The build stages of this command; returns (index, dataset)."""
    device, ds = C.synthetic_setup(cfg, extras)
    index = IVFADCGroupingIndex(cfg.index, device)
    gen = torch.Generator(device=device).manual_seed(0)
    C.setup_quantizer(index, cfg, ds, gen)
    index.compute_neighbor_centroids()
    C.setup_pq(index, cfg, ds, gen)
    idxs = C.load_or_assign(index, cfg, ds)
    C.build_or_read_index(index, cfg, ds, idxs, grouping=True)
    return index, ds


def main(argv=None) -> dict:
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    index, ds = build(cfg, extras)
    return C.eval_search(index, cfg, ds)


if __name__ == "__main__":
    main()
