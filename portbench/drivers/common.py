"""What the drivers share: gaps between the program's readings and the
reference's."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |program - reference|, against the larger of its
    reference value and the median leaf's."""
    names = list(reference if leaves is None else leaves)
    floor = statistics.median(reference[k] for k in names)
    return {k: abs(program[k] - reference[k]) / max(reference[k], floor) for k in names}


def worst_and_median(gaps: Dict[str, float]) -> Tuple[float, str, float]:
    """(the worst leaf's gap, that leaf, the median leaf's gap); a NaN is the worst."""
    worst, where = 0.0, ""
    for k, gap in gaps.items():
        if not gap <= worst:
            worst, where = gap, k
    return worst, where, statistics.median(gaps.values())
