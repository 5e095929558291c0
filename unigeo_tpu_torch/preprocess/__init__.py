"""Offline preprocessors: GT rendering and sensor registration, on the card.

Port of ``unigeo_tpu/preprocess``: the host tools that build ScanNet++'s GT
depth and normals from its meshes (``rasterizer``, ``scannetpp``, with the
COLMAP DSLR path in ``colmap``) and register 7-Scenes' Kinect depth onto
its RGB sensor (``sevenscenes``).  The JAX package runs them in numpy on
the host; here they are tensor code on an explicit device, the card unless
the caller asks for the CPU.
"""

from unigeo_tpu_torch.preprocess.rasterizer import rasterize_mesh  # noqa: F401
from unigeo_tpu_torch.preprocess.sevenscenes import register_depth_to_rgb  # noqa: F401
