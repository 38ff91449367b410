"""Calibration table and bucket cost model, port of ``repro.kernels.tuning``
(the bucket-count half).

With ``EngineConfig.kv_buckets == 0`` the engine asks
:func:`select_kv_buckets` for the bucket count of its strategy.  The choice
reads the strategy's calibrated occupancy histogram (live rows per halving
width class, a property of the plans, not a timing) and is a pure function
of ``(strategy, table)``, fixed before any plan is built.

A bucketed layout has ``B / (2^B − 1)`` of the uniform grid's slots; rows
whose width class is wider than the bucket capacity left for them are
clamped, which costs fidelity.  :func:`bucket_clamp_frac` predicts the
clamped fraction and :func:`select_kv_buckets` takes the deepest candidate
whose prediction stays under ``bucket_model.max_clamp_frac``; an
uncalibrated strategy gets 1 (the uniform grid).

The table (``default_calibration.json`` beside this module) carries the
reference table's ``bucket_model`` and ``strategies`` sections.  The
reference's ``kernel_tiles`` is N/A here: its table holds the TPU
kernels' ``block_k``/``block_f`` defaults, while the Hopper kernels' tiles
are compile-time constants (``csrc/gemm_tile.cuh``, ``Tile<T>``) and no
wrapper takes a tile at run time.  A redesign that takes one brings the
lookup back with entries swept on the H100.  Schema (version 1)::

    {"version": 1,
     "bucket_model": {"max_clamp_frac": 0.02},
     "strategies": {"<name>": {"occ_hist": [..fractions..], "rows": <int>}}}
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Optional

__all__ = ["CANDIDATE_BUCKETS", "DEFAULT_TABLE_PATH", "load_table", "validate_table",
           "bucket_slot_frac", "bucket_clamp_frac", "select_kv_buckets"]

#: Static bucket-count candidates.
CANDIDATE_BUCKETS = (1, 2, 3)

DEFAULT_TABLE_PATH = Path(__file__).with_name("default_calibration.json")

_FALLBACK_TABLE = {"version": 1, "bucket_model": {"max_clamp_frac": 0.02},
                   "strategies": {}}


@functools.lru_cache(maxsize=8)
def load_table(path: Optional[str] = None) -> dict:
    """Load (and memoize) a calibration table, schema-validated; a missing or
    invalid file gives the fallback table (no calibrated strategy, so
    :func:`select_kv_buckets` returns 1)."""
    p = Path(path) if path is not None else DEFAULT_TABLE_PATH
    try:
        table = json.loads(p.read_text())
        validate_table(table)
    except (OSError, ValueError):
        return dict(_FALLBACK_TABLE)
    return table


def validate_table(table: dict) -> None:
    """Raise ``ValueError`` on any schema violation (see module docstring)."""
    if not isinstance(table, dict):
        raise ValueError("calibration table must be a JSON object")
    if table.get("version") != 1:
        raise ValueError(f"unsupported table version {table.get('version')!r}")
    mcf = table.get("bucket_model", {}).get("max_clamp_frac", 0.02)
    if not (isinstance(mcf, (int, float)) and 0.0 <= mcf <= 1.0):
        raise ValueError(f"bucket_model.max_clamp_frac = {mcf!r} not in [0,1]")
    for name, ent in table.get("strategies", {}).items():
        hist = ent.get("occ_hist") if isinstance(ent, dict) else None
        if (not isinstance(hist, list) or not hist
                or any(not isinstance(x, (int, float)) or x < 0 for x in hist)):
            raise ValueError(f"strategies[{name!r}].occ_hist must be non-negative numbers")


def bucket_slot_frac(n_buckets: int) -> float:
    """Grid slots of a ``B``-bucket halving layout over the uniform grid's:
    ``B / (2^B − 1)``."""
    return n_buckets / float((1 << n_buckets) - 1)


def bucket_clamp_frac(hist, n_buckets: int) -> float:
    """Predicted clamped-row fraction of a ``B``-bucket layout.

    ``hist`` is the occupancy histogram over halving width classes (counts
    or fractions).  The Update-time sort fills the widest buckets first, so
    rows of class ``≤ b`` clamp exactly when their cumulative demand exceeds
    the cumulative row capacity of buckets ``0..b`` (``2^b / (2^B − 1)``)."""
    total = float(sum(hist))
    if total <= 0.0 or n_buckets <= 1:
        return 0.0
    frac = [float(h) / total for h in hist]
    denom = float((1 << n_buckets) - 1)
    clamp = demand = cap = 0.0
    for b in range(n_buckets - 1):
        demand += frac[b] if b < len(frac) else 0.0
        cap += (1 << b) / denom
        clamp = max(clamp, demand - cap)
    return max(0.0, clamp)


def select_kv_buckets(strategy: str, table: Optional[dict] = None,
                      candidates=CANDIDATE_BUCKETS) -> int:
    """The deepest candidate whose predicted clamp fraction stays under
    ``bucket_model.max_clamp_frac``; 1 for an uncalibrated strategy."""
    table = load_table() if table is None else table
    ent = table.get("strategies", {}).get(str(strategy))
    if not ent:
        return 1
    hist = ent.get("occ_hist", [])
    max_clamp = table.get("bucket_model", {}).get("max_clamp_frac", 0.02)
    best = 1
    for b in sorted(candidates):
        if b != 1 and bucket_clamp_frac(hist, b) <= max_clamp \
                and bucket_slot_frac(b) < bucket_slot_frac(best):
            best = b
    return int(best)
