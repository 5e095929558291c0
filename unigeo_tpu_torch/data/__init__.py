"""Clip datasets of the port.  Importing this package registers them: the
synthetic box scenes, the eleven disk loaders and Hypersim."""

from unigeo_tpu_torch.data import synthetic  # noqa: F401
from unigeo_tpu_torch.data import loaders  # noqa: F401
from unigeo_tpu_torch.data import hypersim  # noqa: F401
