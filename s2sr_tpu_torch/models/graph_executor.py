"""Direct execution of frozen TF GraphDefs in PyTorch — the converters'
oracle (the port of ``s2sr_tpu/models/graph_executor.py``).

The ``.pb`` converters (:mod:`.pb_reader`) map constants onto the
classic models' parameter trees *structurally*; a systematic misread of
node order would survive shape checks. This module walks the parsed
NodeDefs (``read_graphdef_nodes``) and evaluates the graph node for node
with TF's documented semantics, so a classic model's output can be held
to direct execution of the same file. The JAX package's executor is
numpy; this one is torch ops on the tensors' device, so it runs on the
card too, in IEEE float32 (TF32 off).

The op set is what the released graphs use (Saafke/EDSR_Tensorflow,
fannymonori/TF-ESPCN, fannymonori/TF-LAPSRN, consumed by
``cv2.dnn_superres`` in the reference): Conv2D, Conv2DBackpropInput,
BiasAdd, Relu/LeakyRelu/Tanh, Add, Sub, Mul, Maximum, DepthToSpace,
Placeholder, Const, Identity. Conv2D and Conv2DBackpropInput pad as TF's
SAME does (:func:`_same_pads`, which may put one more row or column at
the end than at the start).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import ieee_fp32
from .pb_reader import read_graphdef_nodes


def _same_pads(in_size: int, stride: int, k: int) -> tuple:
    """TF SAME padding: (pad_begin, pad_end) for one spatial dim."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k - in_size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
           padding: str = "SAME") -> torch.Tensor:
    """TF Conv2D: NHWC × HWIO cross-correlation."""
    _, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    sh, sw = strides
    if padding == "SAME":
        (pt, pb), (pl, pr) = _same_pads(h, sh, kh), _same_pads(wd, sw, kw)
    else:
        pt = pb = pl = pr = 0
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    out = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=(sh, sw))
    return out.permute(0, 2, 3, 1)


def conv2d_backprop_input(out_shape, w: torch.Tensor, y: torch.Tensor,
                          strides=(2, 2),
                          padding: str = "SAME") -> torch.Tensor:
    """TF Conv2DBackpropInput (a.k.a. transposed conv): the exact adjoint
    of :func:`conv2d` from an input of ``out_shape`` (NHWC). ``w`` is the
    forward conv's (kh, kw, in = result channels, out = y channels)
    kernel, i.e. ``conv_transpose2d``'s weight after ``permute(3, 2, 0,
    1)``; the full transposed conv is cropped at the SAME begin pads."""
    kh, kw = w.shape[:2]
    sh, sw = strides
    H, W = int(out_shape[1]), int(out_shape[2])
    if padding == "SAME":
        (pt, _), (pl, _) = _same_pads(H, sh, kh), _same_pads(W, sw, kw)
    else:
        pt = pl = 0
    full = F.conv_transpose2d(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                              stride=(sh, sw))
    # a VALID result may reach past the full transposed conv: zeros there
    full = F.pad(full, (0, max(pl + W - full.shape[3], 0),
                        0, max(pt + H - full.shape[2], 0)))
    return full[:, :, pt:pt + H, pl:pl + W].permute(0, 2, 3, 1)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """TF NHWC DepthToSpace: depth index = (dy·block + dx)·C + c."""
    n, h, w, cf = x.shape
    c = cf // (block * block)
    x = x.reshape(n, h, w, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, c)


def _tensor(value, device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def execute_graphdef(path: Path | str, feed: Dict[str, object],
                     output: str | None = None,
                     device="cuda") -> torch.Tensor:
    """Evaluate a frozen GraphDef. ``feed`` maps Placeholder names to
    NHWC float arrays or tensors; ``output`` defaults to the last node.
    Returns the output tensor on ``device`` (the card unless the caller
    asks for the CPU; a CUDA device without CUDA raises)."""
    from .engine import resolve_device

    device = resolve_device(device)
    nodes = read_graphdef_nodes(path)
    by_name = {n["name"]: n for n in nodes}
    if output is None:
        output = nodes[-1]["name"]
    memo: Dict[str, torch.Tensor] = {}

    def ev(name: str) -> torch.Tensor:
        if name in memo:
            return memo[name]
        node = by_name[name]
        op = node["op"]
        ins = node["inputs"]
        a = node["attrs"]
        if op == "Placeholder":
            val = torch.as_tensor(feed[name]).to(device, torch.float32)
        elif op == "Const":
            val = _tensor(a["value"], device)
        elif op in ("Identity", "StopGradient"):
            val = ev(ins[0])
        elif op == "Conv2D":
            strides = a.get("strides", [1, 1, 1, 1])
            val = conv2d(ev(ins[0]), ev(ins[1]), (strides[1], strides[2]),
                         a.get("padding", "SAME"))
        elif op == "Conv2DBackpropInput":
            strides = a.get("strides", [1, 1, 1, 1])
            val = conv2d_backprop_input(
                ev(ins[0]).tolist(), ev(ins[1]), ev(ins[2]),
                (strides[1], strides[2]), a.get("padding", "SAME"))
        elif op in ("BiasAdd", "Add", "AddV2"):
            val = ev(ins[0]) + ev(ins[1])
        elif op == "Sub":
            val = ev(ins[0]) - ev(ins[1])
        elif op == "Mul":
            val = ev(ins[0]) * ev(ins[1])
        elif op == "Maximum":
            val = torch.maximum(ev(ins[0]), ev(ins[1]))
        elif op == "Relu":
            val = torch.clamp_min(ev(ins[0]), 0)
        elif op == "LeakyRelu":
            v = ev(ins[0])
            val = torch.where(v > 0, v, a.get("alpha", 0.2) * v)
        elif op == "Tanh":
            val = torch.tanh(ev(ins[0]))
        elif op == "DepthToSpace":
            val = depth_to_space(ev(ins[0]), int(a["block_size"]))
        else:
            raise NotImplementedError(f"op {op} (node {name})")
        memo[name] = val
        return val

    with torch.no_grad(), ieee_fp32(device.type == "cuda"):
        return ev(output)
