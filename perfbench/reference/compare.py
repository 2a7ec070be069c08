"""The numbers that decide `correct`, each the widest gap between what
the program produced and what the reference computed."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np


def norm_gaps(got: Dict[str, float], want: Dict[str, float],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between two norms, |got - want|, over the larger
    of that leaf's reference norm and the median leaf's."""
    keys = list(want if keys is None else keys)
    med = float(np.median([want[k] for k in want]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}


def leaf_readings(name: str, got: Dict[str, float], want: Dict[str, float],
                  keys: Optional[Iterable[str]] = None) -> dict:
    """`<name>_gap`, the worst leaf's norm gap, with the median leaf's gap
    and the worst leaf's path beside it."""
    gaps = norm_gaps(got, want, keys)
    worst = max(gaps, key=gaps.get)
    return {f"{name}_gap": gaps[worst],
            f"{name}_gap_median": float(np.median(list(gaps.values()))),
            f"{name}_worst": worst}


def moved_leaves(first_grad: Dict[str, float]) -> list:
    """The leaves whose reference gradient is over a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(first_grad.values())))
    return [k for k, v in first_grad.items() if v > 1e-3 * med]


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def l1_rel(got, want) -> float:
    """sum |got - want| / sum |want| over arrays (tensors or numpy)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def median_rel(got, want) -> float:
    """median |got - want| / median |want| over arrays: the typical
    element's gap, which a few elements far off do not move."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.median(np.abs(got - want))
                 / max(np.median(np.abs(want)), 1e-30))
