"""unigeo_tpu_torch: the PyTorch / CUDA port of unigeo_tpu for NVIDIA Hopper.

The JAX package ``unigeo_tpu`` beside it is the reference; this package
imports nothing of it and nothing of JAX.  Public functions keep the JAX
package's layouts (NHWC frames, packed ``[B, S, H*D]`` attention) so the two
can be compared like with like.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from unigeo_tpu_torch.device import resolve_device, set_exact_f32

__all__ = ["resolve_device", "set_exact_f32"]
