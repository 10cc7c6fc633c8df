"""Typed configuration replacing the reference's Parser.h flag struct.

A copy of ``ivfhnsw_tpu/utils/config.py`` (numpy-free, jax-free), kept in the
port so that ``ivfhnsw_tpu_torch`` never imports the JAX package. The
``-flag value`` grammar of :func:`parse_args` is the same, so the reference's
examples/run_*.sh parameter blocks port verbatim.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class IndexConfig:
    """Structural index parameters (Parser.h data/PQ sections)."""

    d: int = 128                 # vector dimension
    nc: int = 2 ** 14            # number of coarse centroids
    code_size: int = 16          # PQ bytes per vector (M subquantizers, 8 bit each)
    nbits: int = 8               # bits per PQ sub-index (ksub = 2**nbits)
    do_opq: bool = False         # OPQ rotation of residuals
    nsubc: int = 0               # subcentroids per group (0 = plain IVFADC;
                                 # 64 in the grouping scheme, Parser.h:32)

    # HNSW knobs of the reference (Parser.h:17-18); no analog in the exact
    # matmul quantizer, kept so reference configs parse.
    M: int = 16
    efConstruction: int = 500

    @property
    def pq_m(self) -> int:
        """Number of PQ subquantizers (== code_size at 8 bits/sub-index)."""
        return self.code_size * 8 // self.nbits

    @property
    def ksub(self) -> int:
        return 2 ** self.nbits

    @property
    def dsub(self) -> int:
        return self.d // self.pq_m

    def validate(self) -> "IndexConfig":
        if self.d % self.pq_m != 0:
            raise ValueError(f"d={self.d} not divisible by pq_m={self.pq_m}")
        if self.nbits != 8:
            raise ValueError("only 8-bit PQ sub-indices supported (ksub=256)")
        if self.nsubc < 0:
            raise ValueError("nsubc must be >= 0")
        return self


@dataclass
class SearchParams:
    """Query-time knobs (Parser.h search section)."""

    k: int = 10                 # number of neighbors to return
    nprobe: int = 32            # number of probed coarse lists
    max_codes: int = 10000      # scan budget: stop after the list that crosses it
                                # (IndexIVF_HNSW.cpp:290-292 semantics)
    efSearch: int = 80          # no-op for the exact quantizer; kept for config parity
    do_pruning: bool = False    # grouping-scheme subcentroid pruning
    # Padded scan length per query (lanes). None -> derived from max_codes
    # and the longest posting list.
    scan_budget: Optional[int] = None
    # Coarse probe selection of the fused engine: "exact" (full top-k),
    # "binned" (the exact 3-pass bin-min), "approx" (bucketed partial
    # reduction at coarse_recall), "routed" (two-level, needs
    # enable_routed_coarse) or "auto" (routed when the structure exists
    # and nc > 16384, else exact).
    coarse_mode: str = "auto"
    coarse_recall: float = 0.95


@dataclass
class RunConfig:
    """Full driver configuration: the Parser.h surface plus the dataset-size
    block."""

    index: IndexConfig = field(default_factory=IndexConfig)
    search: SearchParams = field(default_factory=SearchParams)

    # Data sizes (Parser.h:21-28)
    nb: int = 0            # base vectors
    nt: int = 0            # learn vectors
    nsubt: int = 65536     # PQ training subset size
    nq: int = 0            # queries
    ngt: int = 1           # groundtruth neighbors per query

    # Paths (Parser.h:39-64). Same flag names as the reference CLI.
    path_base: str = ""
    path_learn: str = ""
    path_q: str = ""
    path_gt: str = ""
    path_centroids: str = ""
    path_precomputed_idxs: str = ""
    path_info: str = ""     # HNSW graph info file: accepted, unused (no graph)
    path_edges: str = ""    # HNSW graph edges file: accepted, unused
    path_pq: str = ""
    path_opq_matrix: str = ""
    path_norm_pq: str = ""
    path_index: str = ""

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        cfg = RunConfig()
        cfg.index = IndexConfig(**raw.pop("index", {}))
        cfg.search = SearchParams(**raw.pop("search", {}))
        for k, v in raw.items():
            setattr(cfg, k, v)
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# Flags routed into the nested dataclasses; everything else is flat on RunConfig.
_INDEX_FLAGS = {"d", "nc", "code_size", "nbits", "do_opq", "nsubc", "M",
                "efConstruction"}
_SEARCH_FLAGS = {"k", "nprobe", "max_codes", "efSearch", "do_pruning",
                 "scan_budget", "coarse_mode", "coarse_recall"}
_BOOL_FLAGS = {"do_opq", "do_pruning"}
_STR_FLAGS = {"coarse_mode"}
_FLOAT_FLAGS = {"coarse_recall"}


def parse_args(argv: Optional[list[str]] = None) -> RunConfig:
    """Parse the reference's ``-flag value`` CLI grammar (Parser.h:135-160)
    into a RunConfig. Also accepts ``-config file.json`` to preload values."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = RunConfig()

    flat = {f.name for f in fields(RunConfig)} - {"index", "search"}
    i = 0
    while i < len(argv):
        flag = argv[i].lstrip("-")
        if i + 1 >= len(argv):
            raise ValueError(f"flag -{flag} missing a value")
        val = argv[i + 1]
        i += 2
        if flag == "config":
            with open(val) as f:
                cfg = RunConfig.from_json(f.read())
        elif flag in _INDEX_FLAGS:
            setattr(cfg.index, flag, _coerce(flag, val))
        elif flag in _SEARCH_FLAGS:
            setattr(cfg.search, flag, _coerce(flag, val))
        elif flag in flat:
            cur = getattr(cfg, flag)
            setattr(cfg, flag, val if isinstance(cur, str) else int(val))
        else:
            raise ValueError(f"unknown flag -{flag}")
    cfg.index.validate()
    return cfg


def _coerce(flag: str, val: str):
    if flag in _BOOL_FLAGS:
        return val.lower() in ("1", "true", "on", "yes")
    if flag in _STR_FLAGS:
        return val
    if flag in _FLOAT_FLAGS:
        return float(val)
    return int(val)
