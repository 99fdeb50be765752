"""Fused residual dense block: the hand-written Hopper kernel and its
plain PyTorch version.

Replaces ``s2sr_tpu/ops/pallas/fused_rdb_v4.py::rdb_pallas_v4``. The
function is ``s2sr_tpu/models/rrdbnet.py::_rdb_packed``: five 3×3 SAME
convs over the dense concat (64→32 ×4, →64), LeakyReLU 0.2,
``out = 0.2·x5 + x``, with an optional 0/1 mask that re-zeroes x1..x4
and the output (the exact masked-bucket serving path, which the TPU
kernel refused).

- :func:`rdb` is the wrapper. On a CUDA tensor it launches the kernel in
  ``csrc/rdb.cu`` (one launch per block, x1..x4 kept in shared memory)
  or raises; on a CPU tensor it runs :func:`rdb_reference`.
- :data:`LAUNCHES` counts kernel launches, nothing else.
- What bounds the kernel on the H100 is operations (479,232 FLOP per
  pixel against 256 bytes per pixel in bf16); the source's header says
  what the design does about it.

Weights travel packed: :func:`pack_rdb_weights` rounds the five conv
kernels and biases to the compute dtype (as the reference casts them)
and stores them as float32, kernels HWIO-flattened and concatenated.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

NF = 64
G = 32
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CIN = (NF, NF + G, NF + 2 * G, NF + 3 * G, NF + 4 * G)
_COUT = (G, G, G, G, NF)


def check_kernel_shapes(kernels) -> None:
    """Raise unless ``kernels`` are the five OIHW conv kernels of an RDB."""
    for k, (cin, cout) in enumerate(zip(_CIN, _COUT)):
        if tuple(kernels[k].shape) != (cout, cin, 3, 3):
            raise ValueError(f"conv{k + 1} kernel has shape "
                             f"{tuple(kernels[k].shape)}, want {(cout, cin, 3, 3)}")


def pack_rdb_weights(kernels, biases, dtype: torch.dtype):
    """Five OIHW conv kernels + biases → ``(w, b)`` float32 flat buffers
    holding values rounded to ``dtype``."""
    check_kernel_shapes(kernels)
    w = torch.cat([k.detach().to(dtype).float().permute(2, 3, 1, 0).reshape(-1)
                   for k in kernels])
    b = torch.cat([bb.detach().to(dtype).float().reshape(-1) for bb in biases])
    return w.contiguous(), b.contiguous()


def unpack_rdb_weights(w: torch.Tensor, b: torch.Tensor):
    """Inverse of :func:`pack_rdb_weights`: five OIHW kernels, five biases."""
    kernels, biases = [], []
    off = boff = 0
    for cin, cout in zip(_CIN, _COUT):
        n = 9 * cin * cout
        kernels.append(w[off:off + n].view(3, 3, cin, cout).permute(3, 2, 0, 1))
        biases.append(b[boff:boff + cout])
        off += n
        boff += cout
    return kernels, biases


def _mask_nchw(mask, x):
    if mask is None:
        return None
    b, h, w, _ = x.shape
    return mask.reshape(b, 1, h, w).to(x.dtype)


def rdb_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, 64) → same, in ``x.dtype``.

    The packed-prefix formulation of ``_rdb_packed`` (per-source wide
    convs, accumulator ``[a5|a4|a3|a2|a1]``) with ``F.conv2d``, so the
    per-lane addition order — and with it the bf16 rounding — follows
    the reference."""
    dtype = x.dtype
    ks, bs = unpack_rdb_weights(w, b)
    ks = [k.to(dtype) for k in ks]
    bs = [bb.to(dtype).view(1, -1, 1, 1) for bb in bs]
    xc = x.permute(0, 3, 1, 2)
    mk = _mask_nchw(mask, x)
    slope = torch.tensor(0.2, dtype=dtype, device=x.device)

    def m(t):
        return t if mk is None else t * mk

    def lrelu(t):
        return torch.where(t >= 0, t, t * slope)

    def sl(k, lo, hi):
        return ks[k - 1][:, lo:hi]

    def conv(t, kernel):
        return F.conv2d(t, kernel, padding=1)

    wx = torch.cat([sl(k, 0, NF) for k in (5, 4, 3, 2, 1)], 0)
    w1 = torch.cat([sl(k, NF, NF + G) for k in (5, 4, 3, 2)], 0)
    w2 = torch.cat([sl(k, NF + G, NF + 2 * G) for k in (5, 4, 3)], 0)
    w3 = torch.cat([sl(k, NF + 2 * G, NF + 3 * G) for k in (5, 4)], 0)
    w4 = sl(5, NF + 3 * G, NF + 4 * G)

    acc = conv(xc, wx)                                   # [a5|a4|a3|a2|a1]
    x1 = m(lrelu(acc[:, -G:] + bs[0]))
    acc = acc[:, :-G] + conv(x1, w1)                     # [a5|a4|a3|a2]
    x2 = m(lrelu(acc[:, -G:] + bs[1]))
    acc = acc[:, :-G] + conv(x2, w2)                     # [a5|a4|a3]
    x3 = m(lrelu(acc[:, -G:] + bs[2]))
    acc = acc[:, :-G] + conv(x3, w3)                     # [a5|a4]
    x4 = m(lrelu(acc[:, -G:] + bs[3]))
    x5 = acc[:, :-G] + conv(x4, w4) + bs[4]
    out = m(x5 * slope + xc)
    return out.permute(0, 2, 3, 1).contiguous()


def _lib():
    from ._build import load

    lib = load("rdb")
    if not getattr(lib, "_s2sr_typed", False):
        vp = ctypes.c_void_p
        lib.s2sr_rdb_forward.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, vp]
        lib.s2sr_rdb_forward.restype = ctypes.c_int
        lib.s2sr_rdb_tile.argtypes = [ctypes.c_int]
        lib.s2sr_rdb_tile.restype = ctypes.c_int
        for name in ("s2sr_rdb_smem_bytes", "s2sr_rdb_macs_per_tile"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_tiling(dtype: torch.dtype) -> dict:
    """The kernel's output tile side, shared-memory bytes per block and
    multiply-adds executed per tile (halo recompute included)."""
    lib = _lib()
    code = _DTYPE_CODE[dtype]
    return {"tile": int(lib.s2sr_rdb_tile(code)),
            "smem_bytes": int(lib.s2sr_rdb_smem_bytes(code)),
            "macs_per_tile": int(lib.s2sr_rdb_macs_per_tile(code))}


def _check(x, w, b, mask):
    if x.dim() != 4 or x.shape[-1] != NF:
        raise ValueError(f"rdb wants (B, H, W, {NF}), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rdb supports float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rdb wants a contiguous NHWC tensor")
    n_w = sum(9 * ci * co for ci, co in zip(_CIN, _COUT))
    for name, t, n in (("w", w, n_w), ("b", b, sum(_COUT))):
        if (t.device != x.device or t.dtype != torch.float32
                or t.dim() != 1 or t.numel() != n or not t.is_contiguous()):
            raise ValueError(f"rdb packed {name} must be a contiguous float32 "
                             f"vector of {n} on {x.device}")
    if mask is not None:
        bsz, h, wd, _ = x.shape
        if (mask.device != x.device or mask.dtype != torch.float32
                or mask.numel() != bsz * h * wd or not mask.is_contiguous()
                or tuple(mask.shape[:3]) != (bsz, h, wd)):
            raise ValueError("rdb mask must be a contiguous float32 "
                             f"(B, H, W[, 1]) tensor on {x.device}")


def rdb(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """One residual dense block, (B, H, W, 64) → same, in ``x.dtype``.

    ``w``, ``b``: :func:`pack_rdb_weights` output on ``x``'s device.
    ``mask``: None or float32 0/1 of shape (B, H, W) or (B, H, W, 1).
    CPU tensors run :func:`rdb_reference`; CUDA tensors launch the
    kernel or raise."""
    global LAUNCHES
    if x.device.type == "cpu":
        return rdb_reference(x, w, b, mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb: unsupported device {x.device}")
    _check(x, w, b, mask)
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz, h, wd,
            _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rdb kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
