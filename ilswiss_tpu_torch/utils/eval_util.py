"""Evaluation statistics (counterpart: ilswiss_tpu/utils/eval_util.py;
`create_stats_ordered_dict`, `get_path_information`).

The reference's rlkit/core/eval_util.py: summary statistics of a
quantity (:91-130) and the path-level return and success keys (:15-80).
Paths arrive as per-episode arrays (returns, lengths, successes), not
lists of dicts.  numpy only, in float64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def create_stats_ordered_dict(name: str, data) -> Dict[str, float]:
    """`<name> Mean`, `Std` (population), `Max` and `Min` of `data`; an
    empty dict for empty data."""
    arr = np.asarray(data, np.float64)
    if arr.size == 0:
        return {}
    return {
        f"{name} Mean": float(arr.mean()),
        f"{name} Std": float(arr.std()),
        f"{name} Max": float(arr.max()),
        f"{name} Min": float(arr.min()),
    }


def get_path_information(returns, lengths, successes=None,
                         prefix: str = "") -> Dict[str, float]:
    """The evaluation's headline keys: AverageReturn (the model-selection
    metric), the Returns and PathLengths statistics, and SuccessRate where
    `successes` is given; each key after `prefix`."""
    stats: Dict[str, float] = {}
    stats[prefix + "AverageReturn"] = float(np.mean(returns))
    stats.update(create_stats_ordered_dict(prefix + "Returns", returns))
    stats.update(create_stats_ordered_dict(prefix + "PathLengths", lengths))
    if successes is not None:
        stats[prefix + "SuccessRate"] = float(np.mean(successes))
    return stats
