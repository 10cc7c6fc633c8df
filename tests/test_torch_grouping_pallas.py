"""The PyTorch port's grouping search against the JAX package's fused
grouping kernel K5 (ivfhnsw_tpu/ops/pallas/grouping_scan.py:113, 256-code
chunk tiles), run in Pallas interpret mode on the CPU as
tests/test_grouping_pallas.py runs it; K6 (1024-code quad tiles) is held in
tests/test_torch_grouping_quad.py, so that each file stays well inside a
minute on the CPU.

Each JAX reference (max_codes off, binding, and with pruning) is computed
once and held against the port's engines "torch", "fused" at 256-code slots
and "fused" at 1024-code slots, within the cross-engine contract
(rtol=1e-4, atol=1e-3; labels may differ only where distances tie).
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu_torch import SearchParams
from test_torch_grouping import (PARAMS, PORT_ENGINES, _jax_index,
                                 assert_same, carry)

torch.set_num_threads(1)
QUERIES = 8  # interpret mode runs a grid step per (query, slot block)


@pytest.fixture(scope="module")
def built():
    return _jax_index(13, opq=False)


@pytest.fixture(scope="module")
def pallas_ref():
    """JAX pallas_interpret results on the first QUERIES queries, computed
    once per (index, layout, params)."""
    cache = {}

    def get(j, queries, layout, p):
        key = (id(j), layout, tuple(sorted(p.items())))
        if key not in cache:
            j.engine, j.scan_layout = "pallas_interpret", layout
            try:
                cache[key] = j.search(queries[:QUERIES], JaxParams(**p))
            finally:
                j.engine, j.scan_layout = "auto", "auto"
        return cache[key]
    return get


def check_port(j, queries, ref, p, port):
    """The port's engine ``port`` on the carried-across index against a
    JAX result ``ref`` on the first QUERIES queries."""
    d1, l1 = ref
    t = carry(j)
    t.engine, t.scan_layout = port
    d2, l2 = t.search(queries[:QUERIES], SearchParams(**p))
    assert_same(np.asarray(d1), np.asarray(l1), d2, l2)


@pytest.mark.parametrize("p", list(PARAMS), ids=list(PARAMS))
@pytest.mark.parametrize("port", PORT_ENGINES, ids=lambda x: "-".join(x))
def test_search_matches_jax_pallas_chunk(built, pallas_ref, p, port):
    j, _, queries = built
    check_port(j, queries, pallas_ref(j, queries, "chunk", PARAMS[p]),
               PARAMS[p], port)
