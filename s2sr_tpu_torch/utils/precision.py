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
    """PyTorch's own convolutions inside the block (im2col and a GEMM per
    image), whose rounding depends neither on the image's shape nor on
    the batch: a zero-padded bucket and a batch then give the unpadded
    single image's values. On CUDA cuDNN is off: it picks its algorithm
    by shape and batch size (a transposed conv differs between 576×432
    and its 576×448 bucket, a 256-channel bf16 conv between a batch of 2
    and one image at 64²; ``chip_smoke.py`` phase ``classic``). On the
    CPU oneDNN is off for float32, for the same reason; the CPU's bf16
    convs are not shape-invariant either way and keep oneDNN. The flag
    as it was afterwards."""
    if device.type == "cuda":
        backend = torch.backends.cudnn
    elif device.type == "cpu" and dtype == torch.float32:
        backend = torch.backends.mkldnn
    else:
        yield
        return
    flag = backend.enabled
    backend.enabled = False
    try:
        yield
    finally:
        backend.enabled = flag
