"""Dataset roots from ``paths.toml``, a copy of ``unigeo_tpu/data/paths.py``.

A dataset constructed with ``root=None`` resolves its root from a
``paths.toml`` keyed by the dataset's ``base_dataset`` name.  Search order:
$UNIGEO_PATHS, ./paths.toml, <repo>/paths.toml.

File format:

    [scannetpp]
    root = "/data/scannetpp"
    [7scenes]
    root = "/data/7scenes"
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

try:  # python 3.11+
    import tomllib as _toml
except ImportError:  # pragma: no cover
    _toml = None


def _candidate_files():
    env = os.environ.get("UNIGEO_PATHS")
    if env:
        yield env
    yield osp.join(os.getcwd(), "paths.toml")
    yield osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), "paths.toml")


def resolve_root(dataset_name: str) -> Optional[str]:
    """The configured root of a dataset; None if it is not registered."""
    if _toml is None:
        return None
    for path in _candidate_files():
        if path and osp.isfile(path):
            with open(path, "rb") as f:
                table = _toml.load(f)
            entry = table.get(dataset_name)
            if isinstance(entry, dict) and "root" in entry:
                return str(entry["root"])
            if isinstance(entry, str):
                return entry
    return None
