"""IEEE float32 for the port's float32 forwards.

cuDNN runs a float32 convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits; the JAX package's float32 is IEEE. :func:`ieee_fp32`
turns TF32 off for cuDNN and cuBLAS around a block and restores both
flags after it. A bfloat16 forward does not need it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32(enabled: bool = True):
    """TF32 off for cuDNN convolutions and cuBLAS products inside the
    block (when ``enabled``); the flags as they were afterwards."""
    if not enabled:
        yield
        return
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
