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


@contextlib.contextmanager
def invariant_convs(device: torch.device, dtype: torch.dtype):
    """PyTorch's own convolutions inside the block on CUDA (im2col and a
    GEMM per image), whose rounding depends neither on the image's shape
    nor on the batch: a zero-padded bucket and a batch then give the
    unpadded single image's values. cuDNN is off: it picks its algorithm
    by shape and batch size (a transposed conv differs between 576×432
    and its 576×448 bucket, a 256-channel bf16 conv between a batch of 2
    and one image at 64²; ``chip_smoke.py`` phase ``classic``); the flag
    as it was afterwards. On the CPU nothing is switched: the classic
    models call PyTorch's own float32 convolution by name
    (``models/classic.py``), without writing oneDNN's process-wide flag,
    and the CPU's bf16 convs are not shape-invariant either way."""
    if device.type != "cuda":
        yield
        return
    flag = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = flag
