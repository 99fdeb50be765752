"""Swin block and window attention: the hand-written Hopper kernels and
their plain PyTorch versions.

Replaces ``s2sr_tpu/ops/pallas/window_attention.py``:

- :func:`swin_block` replaces ``swin_block_fused``: one whole Swin block,
  ``y = x + proj(attn(LN1(x)))``, ``out = y + fc2(gelu(fc1(LN2(y))))``;
- :func:`window_attention` replaces ``window_attention_fused``: LN1 →
  attention → proj, without the residual.

Both take the feature map ``x`` (B, H, W, C) in its own (unrolled) space
and give their result in that space: a shifted block's cyclic roll by
``-shift`` before and ``+shift`` after is part of the function. The
kernels fold it into their addressing; the plain versions call
``torch.roll``. Attention runs over plain 8×8 windows of 64 tokens (the
TPU kernel's window pairs existed only to fill its 128-lane MXU); a
shifted block adds one of four 0/−100 masks, chosen by whether the
window sits in the last window row and/or column of the rolled grid.

Numerics, shared by kernel and plain version: LayerNorm statistics in
float32; every product summed in float32; scores, relative-position
bias, mask and softmax in float32; values rounded to the storage dtype
where the TPU kernel stores them (LN outputs, q/k/v, softmax weights,
head outputs, fc1 output, GELU output, block output). GELU is the exact
erf form in float32 and the tanh form in bfloat16, as the JAX package's
``swinir._gelu``.

- :func:`swin_block` / :func:`window_attention` are the wrappers: on a
  CUDA tensor they launch the kernel of ``csrc/window_attention.cu`` or
  raise; on a CPU tensor they run the plain version.
- :data:`LAUNCHES` counts kernel launches per kernel, nothing else.
- :func:`build_block_tables` turns one block's weights (the released
  checkpoint's names and layouts) into the kernel's inputs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

LAUNCHES = {"swin_block": 0, "window_attention": 0}

# the one configuration the kernels are built for (both registry SwinIR
# models): embed 180, 6 heads of 30, window 8, MLP hidden 360
KERNEL_CONFIG = {"dim": 180, "heads": 6, "window": 8, "hidden": 360}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_EPS = 1e-5


def _roundup(n: int, m: int) -> int:
    return -(-n // m) * m


# --- constant tables (numpy; copies of the JAX package's helpers) -------

def relative_position_index(window: int) -> np.ndarray:
    """(N, N) index into the (2w-1)² bias table (torch Swin convention)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Attention mask of every window of an (h, w) shifted grid,
    (nW, N, N) of 0 / −100."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    windows = img.reshape(h // window, window, w // window, window)
    windows = windows.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def shift_mask_types(window: int, shift: int) -> np.ndarray:
    """The 4 distinct window masks of a shifted grid, (4, N, N): interior,
    last column, last row, corner (the windows of a 2×2 grid)."""
    return shift_mask(2 * window, 2 * window, window, shift)


def mask_type_index(nh: int, nw: int) -> np.ndarray:
    """(nh·nw,) mask type of each window, row-major:
    2·(last window row) + (last window column)."""
    r = (np.arange(nh) == nh - 1).astype(np.int64) * 2
    c = (np.arange(nw) == nw - 1).astype(np.int64)
    return (r[:, None] + c[None, :]).reshape(-1)


# --- tables --------------------------------------------------------------

def build_block_tables(p, num_heads: int, window: int, shift: int,
                       dtype: torch.dtype) -> dict:
    """One Swin block's kernel inputs from its weights ``p`` (a mapping
    with the checkpoint's names relative to the block: ``norm1.weight``,
    ``attn.qkv.weight`` (3C, C), ``attn.relative_position_bias_table``,
    ``mlp.fc1.weight``, ...).

    Matrices are stored (in, out) in ``dtype``; vectors, bias and masks
    in float32 (vectors rounded to ``dtype``). Zero padding, inert in the
    math: head_dim to ``dp`` (30 → 32), the output width C to ``cp``
    (180 → 192) and the hidden width to ``hp`` (360 → 384).

    - ``wqkv`` (C, heads·3·dp): per head ``[q | k | v]``, the query scale
      ``head_dim**-0.5`` folded into q's weight and bias (in float32);
    - ``wo`` (heads·dp, cp): proj, rows per head;
    - ``w1`` (C, hp), ``w2`` (hidden, cp);
    - ``bias`` (heads, N, N): the relative-position bias;
    - ``masks`` (4, N, N): the shift-mask types (zeros when unshifted).
    """
    def f32(name):
        return p[name].detach().float()

    wqkv_t = f32("attn.qkv.weight")                  # (3C, C)
    c = wqkv_t.shape[1]
    hd = c // num_heads
    dp = _roundup(hd, 32)
    cp = _roundup(c, 192)
    hidden = p["mlp.fc1.weight"].shape[0]
    hp = _roundup(hidden, 192)
    dev = wqkv_t.device
    scale = hd ** -0.5

    w = wqkv_t.t().reshape(c, 3, num_heads, hd)      # (C, part, head, d)
    b = f32("attn.qkv.bias").reshape(3, num_heads, hd)
    w = torch.cat([w[:, :1] * scale, w[:, 1:]], 1)
    b = torch.cat([b[:1] * scale, b[1:]], 0)
    wqkv = torch.zeros(c, num_heads, 3, dp, device=dev)
    wqkv[..., :hd] = w.permute(0, 2, 1, 3)
    bqkv = torch.zeros(num_heads, 3, dp, device=dev)
    bqkv[..., :hd] = b.permute(1, 0, 2)

    wo = torch.zeros(num_heads, dp, cp, device=dev)
    wo[:, :hd, :c] = f32("attn.proj.weight").t().reshape(num_heads, hd, c)
    w1 = torch.zeros(c, hp, device=dev)
    w1[:, :hidden] = f32("mlp.fc1.weight").t()
    w2 = torch.zeros(hidden, cp, device=dev)
    w2[:, :c] = f32("mlp.fc2.weight").t()

    def vec(name, n):
        v = torch.zeros(n, device=dev)
        t = f32(name)
        v[:t.numel()] = t
        return v.to(dtype).float().contiguous()

    n = window * window
    idx = torch.from_numpy(relative_position_index(window)).to(dev)
    table = f32("attn.relative_position_bias_table")  # ((2w-1)², heads)
    bias = table[idx.reshape(-1)].reshape(n, n, num_heads).permute(2, 0, 1)
    masks = (shift_mask_types(window, shift) if shift > 0
             else np.zeros((4, n, n), np.float32))

    def mat(t):
        return t.to(dtype).contiguous()

    return {
        "g1": vec("norm1.weight", c), "b1": vec("norm1.bias", c),
        "wqkv": wqkv.reshape(c, -1).to(dtype).contiguous(),
        "bqkv": bqkv.reshape(-1).to(dtype).float().contiguous(),
        "wo": mat(wo.reshape(num_heads * dp, cp)),
        "bo": vec("attn.proj.bias", cp),
        "bias": bias.contiguous(),
        "masks": torch.from_numpy(masks).to(dev).contiguous(),
        "g2": vec("norm2.weight", c), "b2": vec("norm2.bias", c),
        "w1": mat(w1), "bf1": vec("mlp.fc1.bias", hp),
        "w2": mat(w2), "bf2": vec("mlp.fc2.bias", cp),
        "heads": num_heads, "head_dim": hd, "dp": dp, "dim": c,
        "hidden": hidden, "window": window, "shift": shift,
        "dtype": dtype,
    }


def tables_to(t: dict, device) -> dict:
    """The tables with every tensor moved to ``device``."""
    return {k: v.to(device) if torch.is_tensor(v) else v for k, v in t.items()}


# --- plain versions --------------------------------------------------------

def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


def layer_norm(x: torch.Tensor, g, b, dtype) -> torch.Tensor:
    """LayerNorm of float32 ``x`` over its last dim with float32
    statistics, rounded to ``dtype`` (returned as float32)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return _round((x - mean) * torch.rsqrt(var + _EPS) * g + b, dtype)


def gelu(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """GELU of float32 ``h``: tanh form for bf16 storage, erf for fp32."""
    return F.gelu(h, approximate="tanh" if dtype == torch.bfloat16 else "none")


def _partition(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """(B, H, W, C) → rolled windows (B·nW, N, C) float32."""
    b, h, w, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c).float()


def _reverse(t: torch.Tensor, shape, window: int, shift: int) -> torch.Tensor:
    b, h, w, _ = shape
    c = t.shape[-1]
    t = t.reshape(b, h // window, w // window, window, window, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift:
        t = torch.roll(t, (shift, shift), (1, 2))
    return t.contiguous()


def _attention(xw: torch.Tensor, t: dict, shape, dtype) -> torch.Tensor:
    """Rolled windows (Bn, N, C) float32 → proj output without its bias,
    (Bn, N, cp) float32."""
    heads, dp, window = t["heads"], t["dp"], t["window"]
    bn, n, _ = xw.shape
    ln = layer_norm(xw, t["g1"], t["b1"], dtype)
    z = _round(ln @ t["wqkv"].float() + t["bqkv"], dtype)
    z = z.reshape(bn, n, heads, 3, dp).permute(3, 0, 2, 1, 4)
    q, k, v = z[0], z[1], z[2]                       # (Bn, heads, N, dp)
    s = q @ k.transpose(-1, -2) + t["bias"]
    if t["shift"]:
        b, h, w, _ = shape
        types = torch.from_numpy(mask_type_index(h // window, w // window))
        types = types.to(xw.device).repeat(b)
        s = s + t["masks"][types][:, None]
    p = _round(torch.softmax(s, -1), dtype)
    o = _round(p @ v, dtype)                         # (Bn, heads, N, dp)
    o = o.permute(0, 2, 1, 3).reshape(bn, n, heads * dp)
    return o @ t["wo"].float()


def window_attention_reference(x: torch.Tensor, t: dict) -> torch.Tensor:
    """Plain version of :func:`window_attention`: (B, H, W, C) → the
    projected attention output (B, H, W, C) in ``x.dtype``, no residual."""
    dtype, c = x.dtype, t["dim"]
    xw = _partition(x, t["window"], t["shift"])
    out = _round(_attention(xw, t, x.shape, dtype) + t["bo"], dtype)
    return _reverse(out[..., :c], x.shape, t["window"], t["shift"]).to(dtype)


def swin_block_reference(x: torch.Tensor, t: dict) -> torch.Tensor:
    """Plain version of :func:`swin_block`: (B, H, W, C) → same, in
    ``x.dtype``."""
    dtype, c, hidden = x.dtype, t["dim"], t["hidden"]
    xw = _partition(x, t["window"], t["shift"])
    y = xw + _attention(xw, t, x.shape, dtype)[..., :c] + t["bo"][:c]
    ln = layer_norm(y, t["g2"], t["b2"], dtype)
    hdn = _round(ln @ t["w1"].float() + t["bf1"], dtype)[..., :hidden]
    hdn = _round(gelu(hdn, dtype), dtype)
    mlp = hdn @ t["w2"].float() + t["bf2"]
    out = _round(y + mlp[..., :c], dtype)
    return _reverse(out, x.shape, t["window"], t["shift"]).to(dtype)


# --- kernels ---------------------------------------------------------------

def _lib():
    from ._build import load

    lib = load("window_attention")
    if not getattr(lib, "_s2sr_typed", False):
        vp = ctypes.c_void_p
        lib.s2sr_swin_forward.argtypes = ([vp] * 16 + [ctypes.c_int] * 6
                                          + [vp])
        lib.s2sr_swin_forward.restype = ctypes.c_int
        lib.s2sr_swin_smem_bytes.argtypes = []
        lib.s2sr_swin_smem_bytes.restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_smem_bytes() -> int:
    """Dynamic shared memory per block of both kernels."""
    return int(_lib().s2sr_swin_smem_bytes())


# the tables' shapes at the kernel's configuration (C 180 → 192,
# 6 heads · 3 · 32 = 576 qkv columns, hidden 360 → 384)
_TABLE_SHAPES = {
    "g1": (180,), "b1": (180,), "wqkv": (180, 576), "bqkv": (576,),
    "wo": (192, 192), "bo": (192,), "bias": (6, 64, 64), "masks": (4, 64, 64),
    "g2": (180,), "b2": (180,), "w1": (180, 384), "bf1": (384,),
    "w2": (360, 192), "bf2": (192,),
}
_MATRICES = ("wqkv", "wo", "w1", "w2")


def _check(name: str, x: torch.Tensor, t: dict) -> None:
    cfg = KERNEL_CONFIG
    got = {"dim": t["dim"], "heads": t["heads"], "window": t["window"],
           "hidden": t["hidden"]}
    if got != cfg or t["dp"] != 32:
        raise ValueError(f"{name}: the kernel is built for {cfg}, got {got}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} supports float32/bfloat16, got {x.dtype}")
    if t["dtype"] != x.dtype:
        raise TypeError(f"{name}: tables built for {t['dtype']}, input is "
                        f"{x.dtype}")
    if x.dim() != 4 or x.shape[-1] != cfg["dim"]:
        raise ValueError(f"{name} wants (B, H, W, {cfg['dim']}), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % cfg["window"] or x.shape[2] % cfg["window"]:
        raise ValueError(f"{name}: H and W must be multiples of "
                         f"{cfg['window']}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} wants a contiguous NHWC tensor")
    if not 0 <= t["shift"] < cfg["window"]:
        raise ValueError(f"{name}: shift {t['shift']} out of range")
    for key, shape in _TABLE_SHAPES.items():
        v = t[key]
        want_dtype = x.dtype if key in _MATRICES else torch.float32
        if (v.device != x.device or v.dtype != want_dtype
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"{name}: table {key} must be a contiguous "
                             f"{want_dtype} {shape} tensor on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _launch(name: str, x: torch.Tensor, t: dict, mlp: bool) -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    _check(name, x, t)
    bsz, h, w, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * w == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_swin_forward(
            x.data_ptr(), out.data_ptr(),
            *(t[k].data_ptr() for k in ("g1", "b1", "wqkv", "bqkv", "wo",
                                        "bo", "bias", "masks", "g2", "b2",
                                        "w1", "bf1", "w2", "bf2")),
            bsz, h, w, t["shift"], _DTYPE_CODE[x.dtype], int(mlp), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def swin_block(x: torch.Tensor, t: dict) -> torch.Tensor:
    """One whole Swin block, (B, H, W, C) → same, in ``x.dtype``, with
    ``t`` from :func:`build_block_tables`. CPU tensors run
    :func:`swin_block_reference`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return swin_block_reference(x, t)
    return _launch("swin_block", x, t, mlp=True)


def window_attention(x: torch.Tensor, t: dict) -> torch.Tensor:
    """LN1 → window attention → proj, (B, H, W, C) → same, no residual.
    CPU tensors run :func:`window_attention_reference`; CUDA tensors
    launch the kernel or raise."""
    if x.device.type == "cpu":
        return window_attention_reference(x, t)
    return _launch("window_attention", x, t, mlp=False)
