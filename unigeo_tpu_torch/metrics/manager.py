"""Per-sequence metrics table -> CSV, port of ``unigeo_tpu/metrics/manager.py``
without pandas.

The file is byte for byte what the JAX package's pandas ``to_csv`` writes:
an empty first header cell, then the metric names; one row per sequence; an
``Average`` row of each column's mean over its non-empty cells; floats as
``%.5f``; an empty cell for NaN; ``csv`` quoting (minimal) and ``\\n`` line
ends.  The CSV is rewritten atomically after every clip and doubles as the
resume journal: ``from_csv`` reloads it so scored sequences are skipped.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional

import numpy as np


def _cell(value: float) -> str:
    return "" if math.isnan(value) else "%.5f" % value


class MetricsManager:
    def __init__(self, metric_names: List[str], sequence_names: Optional[List[str]] = None):
        self.metric_names = list(metric_names)
        self.sequence_names: List[str] = []
        self._rows: Dict[str, Dict[str, float]] = {}
        for seq in sequence_names or []:
            self._add(seq)

    def _add(self, seq_name: str) -> None:
        if seq_name not in self._rows:
            self.sequence_names.append(seq_name)
            self._rows[seq_name] = {m: math.nan for m in self.metric_names}

    def update_metrics(self, metrics_dict: Dict[str, float]) -> None:
        seq_name = metrics_dict.get("seq_name")
        if seq_name is None:
            raise ValueError("metrics dict must contain 'seq_name'")
        self._add(seq_name)
        for metric in self.metric_names:
            if metric in metrics_dict:
                self._rows[seq_name][metric] = float(metrics_dict[metric])

    def calculate_averages(self) -> Dict[str, float]:
        """Each column's mean over its non-NaN cells (NaN if none), summed
        as pandas' ``mean(skipna=True)`` sums: NaN as 0, numpy's sum, over
        the count."""
        out = {}
        for m in self.metric_names:
            col = np.array([self._rows[s][m] for s in self.sequence_names], np.float64)
            valid = ~np.isnan(col)
            n = int(valid.sum())
            out[m] = float(np.where(valid, col, 0.0).sum() / n) if n else math.nan
        return out

    def export_to_csv(self, filepath: str) -> None:
        if not self.sequence_names:
            return
        dirname = os.path.dirname(filepath)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        # atomic replace: a crash mid-write never leaves a torn file for
        # from_csv to reload
        tmp = filepath + ".tmp"
        averages = self.calculate_averages()
        with open(tmp, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow([""] + self.metric_names)
            for seq in self.sequence_names:
                writer.writerow([seq] + [_cell(self._rows[seq][m]) for m in self.metric_names])
            writer.writerow(["Average"] + [_cell(averages[m]) for m in self.metric_names])
        os.replace(tmp, filepath)

    @classmethod
    def from_csv(cls, filepath: str, metric_names: List[str]) -> "MetricsManager":
        """Reload an exported CSV to resume an interrupted eval (columns not
        in ``metric_names`` and the ``Average`` row are dropped)."""
        mgr = cls(metric_names)
        if os.path.isfile(filepath):
            with open(filepath, newline="") as f:
                rows = list(csv.reader(f))
            header = rows[0][1:] if rows else []
            for row in rows[1:]:
                if row[0] == "Average":
                    continue
                rec = {"seq_name": row[0]}
                rec.update({k: float(v) if v != "" else math.nan
                            for k, v in zip(header, row[1:]) if k in metric_names})
                mgr.update_metrics(rec)
        return mgr

    def has_sequence(self, seq_name: str) -> bool:
        return seq_name in self._rows

    def rows(self) -> List[Dict[str, float]]:
        """Per-sequence rows as dicts, NaN metrics omitted (so that
        ``update_metrics`` round-trips them)."""
        out = []
        for seq in self.sequence_names:
            row: Dict[str, float] = {"seq_name": seq}
            row.update({m: v for m, v in self._rows[seq].items() if not math.isnan(v)})
            out.append(row)
        return out
