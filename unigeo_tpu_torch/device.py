"""Device and dtype policy.

Production runs on the card in bf16; parity checks run in f32 (on the CPU,
or on the card with TF32 off).  A caller that does not ask for the CPU gets
the card, and a missing card is an error: nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib

import numpy as np
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


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block, the
    caller's flags restored after it: the geometry that must stay f32
    (camera solver, focal, world points) whatever the process has set."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    set_exact_f32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def to_host(x) -> np.ndarray:
    """A tensor on any device -> a numpy array on the host (bf16, which numpy
    lacks, as f32); anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)
