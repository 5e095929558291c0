"""Clip datasets of the port.  Importing this package registers them."""

from unigeo_tpu_torch.data import synthetic  # noqa: F401
