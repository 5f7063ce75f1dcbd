"""Batching of per-pair samples.

Counterpart of ``collate`` in ``islam_tpu/data/dataset.py``; the folder
datasets (KITTI, EuRoC, TartanAir) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def collate(samples: List[Dict]) -> Dict:
    """Stack a list of per-pair samples into batched numpy arrays."""
    out = {}
    for k in samples[0].keys():
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out
