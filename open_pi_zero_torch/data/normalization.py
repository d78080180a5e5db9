"""Dataset statistics (counterpart of ``load_statistics_file`` in the JAX
package's ``data/normalization.py``; reference
src/data/utils/data_utils.py). Only the reader is ported: the statistics'
computation and the trajectory normalization are ``tf.data`` transforms
that wait with the data pipeline (ROADMAP.md queue 1, item 10).

Schema of the reference JSONs (configs/statistics/*.json):
{action|proprio: {mean, std, max, min, p99, p01}, num_transitions,
num_trajectories}, possibly keyed by a dataset path at the top level.
"""

from __future__ import annotations

import json
from typing import Optional


def load_statistics_file(path: str, dataset_name: Optional[str] = None) -> dict:
    """Load a statistics JSON; reference files may key stats by dataset
    path (configs/statistics/*.json top-level key)."""
    with open(path) as f:
        stats = json.load(f)
    if "action" not in stats:
        if dataset_name is not None and dataset_name in stats:
            stats = stats[dataset_name]
        else:
            stats = next(iter(stats.values()))
    return stats
