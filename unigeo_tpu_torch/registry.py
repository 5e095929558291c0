"""Explicit name -> class registries of datasets and models, a copy of
``unigeo_tpu/registry.py``'s ``register`` and ``get``.

The port's dataset modules register themselves when ``unigeo_tpu_torch.data``
is imported, its model modules when ``get_model_cls`` imports them; a name
the port does not have yet raises ``KeyError`` listing the names it has.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, type] = {}

    def register(self, name: Optional[str] = None) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            key = name or cls.__name__
            if key in self._entries and self._entries[key] is not cls:
                raise ValueError(f"duplicate {self.kind} registration: {key}")
            self._entries[key] = cls
            return cls

        return deco

    def get(self, name: str) -> type:
        try:
            return self._entries[name]
        except KeyError:
            avail = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(f"unknown {self.kind} {name!r}; registered: {avail}") from None


DATASETS = Registry("dataset")
MODELS = Registry("model")


def get_dataset_cls(name: str) -> type:
    import unigeo_tpu_torch.data  # noqa: F401  (self-registering modules)

    return DATASETS.get(name)


def get_model_cls(name: str) -> type:
    # the self-registering model modules
    import unigeo_tpu_torch.models.aether  # noqa: F401
    import unigeo_tpu_torch.models.chronodepth  # noqa: F401
    import unigeo_tpu_torch.models.depthanyvideo  # noqa: F401
    import unigeo_tpu_torch.models.depthcrafter.model  # noqa: F401
    import unigeo_tpu_torch.models.identity  # noqa: F401
    import unigeo_tpu_torch.models.pointmap.cut3r  # noqa: F401
    import unigeo_tpu_torch.models.pointmap.dust3r  # noqa: F401
    import unigeo_tpu_torch.models.pointmap.spann3r  # noqa: F401
    import unigeo_tpu_torch.models.stablenormal  # noqa: F401
    import unigeo_tpu_torch.models.unigeo_cam  # noqa: F401
    import unigeo_tpu_torch.models.vda  # noqa: F401

    return MODELS.get(name)
