"""The comparisons that decide ``correct``: the program's answers from the
timed window against the float64 reference, and the control (the
reference in the program's place at TF32).

A configuration's reference is the module ``reference/<name>.py``, where
``name`` is the configuration's ``"reference"`` key, or its ``index`` when
it has none. The module provides

- ``judge_search(cfg, dep, cb, norms, Qs, D, L, owner, state)``: (numbers,
  reference) of the window's answers D, L [n, k] (answer i belongs to
  sample query owner[i]) to the sample queries Qs [m, d], ``state`` the
  system's ``judge_state``;
- ``control_search(cfg, dep, cb, norms, Qs, prec_name)``: the reference's
  own (D, L, state) in ``prec_name``, judged in the program's place;
- for a configuration with add cells, ``judge_add(cfg, dep, cb, norms, x,
  keys, codes, norm_codes, missing)`` and ``control_add(cfg, dep, cb,
  norms, x, prec_name)``.

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

import importlib

from annbench.reference.core import INF


def reference_module(cfg: dict):
    """The reference module of configuration ``cfg``."""
    return importlib.import_module(
        f"annbench.reference.{cfg.get('reference', cfg['index'])}")


def worst(v: float) -> float:
    """A reading as printed: +inf as 1e30 (JSON has no infinity)."""
    return 1e30 if v == INF or v != v else v
