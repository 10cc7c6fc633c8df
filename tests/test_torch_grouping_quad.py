"""The PyTorch port's grouping search against the JAX package's fused
grouping kernel K6 (ivfhnsw_tpu/ops/pallas/grouping_scan.py:248, 1024-code
quad tiles, the layout the flagship point resolves to), in Pallas interpret
mode on the CPU: max_codes off, binding, and with pruning, and the flagship
combination of OPQ and pruning. Tolerances and engines as in
tests/test_torch_grouping_pallas.py.
"""

import pytest
import torch

from test_torch_grouping import PARAMS, PORT_ENGINES, _jax_index
from test_torch_grouping_pallas import check_port, pallas_ref  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    return _jax_index(13, opq=False)


@pytest.fixture(scope="module")
def built_opq():
    return _jax_index(31, opq=True)


@pytest.mark.parametrize("p", list(PARAMS), ids=list(PARAMS))
@pytest.mark.parametrize("port", PORT_ENGINES, ids=lambda x: "-".join(x))
def test_search_matches_jax_pallas_quad(built, pallas_ref, p, port):
    j, _, queries = built
    check_port(j, queries, pallas_ref(j, queries, "quad", PARAMS[p]),
               PARAMS[p], port)


@pytest.mark.parametrize("port", PORT_ENGINES, ids=lambda x: "-".join(x))
def test_search_opq_matches_jax_pallas_quad(built_opq, pallas_ref, port):
    """The flagship combination: OPQ, pruning, 1024-code quad tiles."""
    j, _, queries = built_opq
    p = PARAMS["prune"]
    check_port(j, queries, pallas_ref(j, queries, "quad", p), p, port)
