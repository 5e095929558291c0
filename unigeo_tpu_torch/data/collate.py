"""Batch collation for clip samples (the trainers' batch builders), a copy
of ``unigeo_tpu/data/collate.py`` on numpy.

Samples are already stacked arrays, so collation is one more leading batch
axis plus list handling (the reference's dataset_core/utils/utils.py:
117-258 and its batched list indexing, :284-352).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


def collate_clips(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """List of clip dicts → one batched dict ([B, Nf, ...] arrays).

    Non-array values become lists; all clips must share array shapes.
    """
    assert samples, "empty batch"
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif np.isscalar(first) and not isinstance(first, str):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


def uncollate_clips(batch: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Inverse of collate_clips."""
    sizes = {
        len(v) for v in batch.values() if isinstance(v, (list, np.ndarray))
    }
    assert len(sizes) == 1, f"inconsistent batch sizes: {sizes}"
    b = sizes.pop()
    return [
        {
            k: (v[i] if isinstance(v, (list, np.ndarray)) else v)
            for k, v in batch.items()
        }
        for i in range(b)
    ]


def index_batched(batch: Dict[str, Any], idx) -> Dict[str, Any]:
    """Fancy-index every batched value (the reference's batched list
    indexing, utils.py:284-352)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = v[idx]
        elif isinstance(v, list):
            if isinstance(idx, (list, np.ndarray)):
                out[k] = [v[i] for i in np.asarray(idx).tolist()]
            else:
                out[k] = v[idx]
        else:
            out[k] = v
    return out


def seed_everything(seed: int) -> np.random.Generator:
    """Seed numpy + python random; returns a fresh Generator
    (reference: utils.py:14-21).  Torch draws stay explicit (generators)."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    return np.random.default_rng(seed)
