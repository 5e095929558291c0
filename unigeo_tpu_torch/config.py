"""Experiment configs: a copy of ``unigeo_tpu/config.py`` (numpy and yaml).

The YAML schema is the reference UniGeo one (dataset class name, root,
h, w, clip_length, clip_overlap, split, model_name, model_params, the
eval_* sections).  ``EvalConfig.from_dict`` takes it as a dict, so a caller
without a YAML file or the ``yaml`` package can build one; ``from_yaml``
reads a ``.json`` file with ``json`` and imports ``yaml`` only for YAML.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional


def load_config(path: str) -> Dict[str, Any]:
    """A YAML config, or a JSON one (``.json``, read without PyYAML)."""
    with open(path, "r") as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


def parse_dataset_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Dataset kwargs of an experiment config (defaults clip_length 30,
    clip_overlap 0, as the reference's)."""
    out = {
        "root": config.get("root"),
        "clip_length": config.get("clip_length", 30),
        "clip_overlap": config.get("clip_overlap", 0),
        "input_size": (config["h"], config["w"]),
        "target_size": (config["h"], config["w"]),
    }
    if "split" in config:
        out["split"] = config["split"]
    # loader-specific kwargs pass through verbatim
    out.update(config.get("dataset_params") or {})
    return out


_METRIC_SECTIONS = ("eval_depth", "eval_pcd", "eval_camera", "eval_normal")


def parse_metric_config(config: Dict[str, Any]) -> List[str]:
    """Metric column names of the eval_* sections, in their order."""
    metric_names: List[str] = []
    for section in _METRIC_SECTIONS:
        if section in config:
            metric_names.extend(config[section]["metric_names"])
    return metric_names


_ALIGNMENT_MODES = ("lstsq", "median", "lad", "lad2", "scale", "metric")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Typed view over an experiment config."""

    dataset: str
    model_name: str
    dataset_kwargs: Dict[str, Any]
    model_params: Dict[str, Any]
    metric_names: List[str]
    eval_depth: bool
    eval_normal: bool
    eval_pcd: bool
    eval_camera: bool
    depth_alignment: str = "lstsq"
    pcd_downsample_num: int = -1
    vis_depth: bool = False
    vis_pcd: bool = False
    max_depth: float = 80.0
    raw: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "EvalConfig":
        depth_alignment = "lstsq"
        if "eval_depth" in config:
            depth_alignment = config["eval_depth"].get("depth_alignment", "lstsq")
            if depth_alignment not in _ALIGNMENT_MODES:
                raise ValueError(
                    f"unknown depth_alignment {depth_alignment!r}; "
                    f"expected one of {_ALIGNMENT_MODES}"
                )
        return cls(
            dataset=config["dataset"],
            model_name=config["model_name"],
            dataset_kwargs=parse_dataset_config(config),
            model_params=config.get("model_params") or {},
            metric_names=parse_metric_config(config),
            eval_depth="eval_depth" in config,
            eval_normal="eval_normal" in config,
            eval_pcd="eval_pcd" in config,
            eval_camera="eval_camera" in config,
            depth_alignment=depth_alignment,
            pcd_downsample_num=(
                config["eval_pcd"].get("pcd_downsample_num", -1)
                if "eval_pcd" in config
                else -1
            ),
            vis_depth=bool(config.get("vis_depth", False)),
            vis_pcd=bool(config.get("vis_pcd", False)),
            max_depth=float(
                (config.get("eval_depth") or {}).get(
                    "max_depth", config.get("max_depth", 80.0)
                )
            ),
            raw=config,
        )

    @classmethod
    def from_yaml(cls, path: str) -> "EvalConfig":
        return cls.from_dict(load_config(path))
