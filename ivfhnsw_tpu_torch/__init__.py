"""ivfhnsw_tpu_torch — the IVFADC and Grouping+Pruning engines of
``ivfhnsw_tpu`` ported to PyTorch and CUDA for NVIDIA Hopper (H100).

Layout mirrors the JAX package: ``ops/`` (distances, top-k, k-means, PQ,
OPQ, segment sums, the grouping terms, the portable ADC scan), ``ops/cuda/``
(the fused search engines around the hand-written kernels; counterpart of
``ops/pallas/``), ``csrc/`` (the CUDA sources), ``models/`` (posting-list
store, ``IVFADCIndex``, ``IVFADCGroupingIndex``), ``drivers/`` and
``utils/``. The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams  # noqa: F401
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex  # noqa: F401
from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex  # noqa: F401
