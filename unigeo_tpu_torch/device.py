"""Device and dtype policy.

Production runs on the card in bf16; parity checks run in f32 (on the CPU,
or on the card with TF32 off).  A caller that does not ask for the CPU gets
the card, and a missing card is an error: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

PRODUCTION_DTYPE = torch.bfloat16


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def set_exact_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions, so that f32 on the
    card is f32 when it is compared with a reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
