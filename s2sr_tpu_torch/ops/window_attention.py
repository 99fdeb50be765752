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

On a band of H (the ``sp`` axis, ``parallel/spatial.py``) the bands roll
H among themselves before and after the block (``spatial.roll_up`` /
``roll_down``), and the functions are told so: ``rolled=True`` rolls W
alone, and ``last`` says whether the band's last window row is the
image's, so that the mask types are the whole image's.

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
- :data:`LAUNCHES` counts the served bf16 kernel's launches per kernel,
  :data:`LAUNCHES_F32` the served float32 kernel's, nothing else;
  :data:`LAUNCHES_MMA`, :data:`LAUNCHES_NO_L2` and :data:`LAUNCHES_FFMA`
  those of the designs nothing served launches (``design="mma"``,
  ``"no_l2"``, ``"ffma"``).
- :func:`build_block_tables` turns one block's weights (the released
  checkpoint's names and layouts) into the kernel's inputs; for bf16 it
  adds the matrices as the served kernel's B slabs
  (:func:`pack_wg_slabs`) and as the ``mma.sync`` design's B fragments
  (:func:`pack_mma_b`), for float32 as the served kernel's TF32 hi and
  lo units (:func:`pack_f32_wg_units`), and the compact bias table for
  both dtypes.

The served bf16 kernel, ``swin_wg_kernel``, runs every product on
``wgmma``, two windows a block sharing each B slab a producer warpgroup
streams through a ring of bulk copies; ``swin_tc_kernel`` (``mma.sync``,
a window a block), the design it replaced, is reached only through
``design="mma"``, so that one call can time both. The served float32
kernel, ``swin_f32_wg_kernel``, is the same design in split TF32 (three
TF32 products a multiply-add: float32's accuracy on the tensor cores;
``csrc/window_attention.cu`` says how); ``swin_kernel<float>``, float32 FMA on
the CUDA cores, the design it replaced, is reached only through
``design="ffma"``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .rdb import tf32_split

LAUNCHES = {"swin_block": 0, "window_attention": 0}
# launches of the served float32 kernel, swin_f32_wg_kernel
LAUNCHES_F32 = {"swin_block": 0, "window_attention": 0}
# launches of swin_tc_kernel (design "mma"), of swin_wg_no_l2_kernel
# (design "no_l2", swin_block only) and of swin_kernel<float> (design
# "ffma"), which nothing served makes
LAUNCHES_MMA = {"swin_block": 0, "window_attention": 0}
LAUNCHES_NO_L2 = {"swin_block": 0}
LAUNCHES_FFMA = {"swin_block": 0, "window_attention": 0}
# the kernels a wrapper can launch: the served one of its dtype; for bf16
# the mma.sync design it replaced and the time-attribution instance of the
# served one; for float32 the CUDA-core design it replaced
DESIGNS = ("served", "mma", "no_l2", "ffma")
BF16_DESIGNS = ("mma", "no_l2")

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


def mask_type_index(nh: int, nw: int, last: bool = True) -> np.ndarray:
    """(nh·nw,) mask type of each window, row-major:
    2·(last window row) + (last window column); with ``last`` False no
    row is the image's last (a band of H above the last)."""
    r = (np.arange(nh) == (nh - 1 if last else -1)).astype(np.int64) * 2
    c = (np.arange(nw) == nw - 1).astype(np.int64)
    return (r[:, None] + c[None, :]).reshape(-1)


# --- tables --------------------------------------------------------------

def mma_b_index(kpad: int, n: int) -> torch.Tensor:
    """For each slot of :func:`pack_mma_b`'s output, in order, the flat
    index of the (kpad, n) matrix element it holds: ``mma.m16n8k16``'s B
    fragments ``[kpad/16][n/8][lane][4]``, lane ``4g + t`` holding rows
    2t, 2t+1, 2t+8, 2t+9 of column g of its k16 slab and n8 tile, the
    order in which ``swin_tc_kernel`` loads them (one 8-byte load a lane
    per tile)."""
    # row 16s + 8a + 2t + e, column 8j + g → [s][j][g][t][a][e]
    return (torch.arange(kpad * n).reshape(kpad // 16, 2, 4, 2, n // 8, 8)
            .permute(0, 4, 5, 2, 1, 3).reshape(-1))


def pack_mma_b(w: torch.Tensor, kpad: int) -> torch.Tensor:
    """A (K, N) matrix, K padded with zero rows to ``kpad`` (a multiple of
    16) and N a multiple of 8, as the bf16 B fragments of
    :func:`mma_b_index`, shape (kpad/16, N/8, 32, 4)."""
    k, n = w.shape
    wp = torch.zeros(kpad, n, dtype=torch.bfloat16, device=w.device)
    wp[:k] = w
    idx = mma_b_index(kpad, n).to(w.device)
    return wp.reshape(-1)[idx].reshape(kpad // 16, n // 8, 32, 4)


# the mma.sync design's packed matrices: key → the table's matrix
MMA_KEYS = {"wqkv_mma": "wqkv", "wo_mma": "wo", "w1_mma": "w1",
            "w2_mma": "w2"}

# The served kernel's B slabs: 96 rows (output columns) × 64 K values
# each, in wgmma's K-major layout with the 128-byte swizzle; the stream
# in the order the kernel reads it (csrc/window_attention.cu).
SLAB_ROWS, SLAB_K = 96, 64
WG_MATRICES = {"wqkv": (180, 576), "wo": (192, 192), "w1": (180, 384),
               "w2": (360, 192)}
RING_SLOTS, RING_SLOT_BYTES = 6, SLAB_ROWS * SLAB_K * 2


def wg_slab_plan() -> list:
    """The stream's slabs in order, each ``(matrix, first K row, first
    column)``: qkv of heads 0..5 (the head's 96 columns, 3 K blocks each),
    proj (per K block columns 0.., 96..), then per half h of the hidden
    fc1's quarters 2h and 2h + 1 (3 K blocks each) and fc2's K rows 192h..
    (per K block two column halves): 48 slabs, the first 24
    window_attention's."""
    plan = [("wqkv", 64 * kb, 96 * h) for h in range(6) for kb in range(3)]
    plan += [("wo", 64 * kb, 96 * s) for kb in range(3) for s in range(2)]
    for h in range(2):
        plan += [("w1", 64 * kb, 192 * h + 96 * q)
                 for q in range(2) for kb in range(3)]
        plan += [("w2", 192 * h + 64 * kb, 96 * s)
                 for kb in range(3) for s in range(2)]
    return plan


def _slab_index(plan, per_chunk: int) -> torch.Tensor:
    """For each value of a stream of 96-row slabs in wgmma's K-major layout
    with the 128-byte swizzle, ``per_chunk`` values a 16-byte chunk (8 K
    values a row of bf16, 4 of float32: a row is 128 bytes), the flat index
    of the matrix element it holds in ``wqkv``, ``wo``, ``w1``, ``w2``
    flattened (in, out) and concatenated in that order, offset by ``half``
    times their size (``plan``: (matrix, first K row, first column, half)
    a slab), −1 for a K pad: slab row n holds column n0 + n, its 16-byte
    chunk p the logical chunk p ^ (n % 8), K rows k0 + per_chunk (p ^ (n
    % 8)) ..."""
    offs, off = {}, 0
    for name, (k, n) in WG_MATRICES.items():
        offs[name] = off
        off += k * n
    row = torch.arange(SLAB_ROWS)[:, None, None]
    chunk = torch.arange(8)[None, :, None] ^ (row % 8)
    kk = per_chunk * chunk + torch.arange(per_chunk)[None, None, :]
    slabs = []
    for name, k0, n0, half in plan:
        k, n = WG_MATRICES[name]
        idx = half * off + offs[name] + (k0 + kk) * n + n0 + row
        slabs.append(torch.where(k0 + kk < k, idx, -1))
    return torch.stack(slabs).reshape(-1)


def wg_slab_index(device=None) -> torch.Tensor:
    """For each bf16 of the stream, (48, 96, 64) flattened, the flat index
    of the matrix element it holds in ``wqkv``, ``wo``, ``w1``, ``w2``
    flattened (in, out) and concatenated in that order, −1 for a K pad
    (qkv and fc1's K 180 → 192, fc2's 360 → 384): slab row n holds column
    n0 + n, its 16-byte chunk p the logical chunk p ^ (n % 8), K rows
    k0 + 8 (p ^ (n % 8)) ... (:func:`_slab_index`)."""
    key = ("bf16", str(device))
    if key not in _INDEX:
        _INDEX[key] = _slab_index([(*u, 0) for u in wg_slab_plan()], 8).to(device)
    return _INDEX[key]


# the stream indices, by dtype and device
_INDEX: dict = {}


def pack_wg_slabs(t: dict) -> torch.Tensor:
    """The tables' ``wqkv``, ``wo``, ``w1``, ``w2`` as the served kernel's
    B slabs (:func:`wg_slab_index`), (48, 96, 64) in their dtype, K pads
    zero; exact."""
    flat = torch.cat([t[k].reshape(-1) for k in WG_MATRICES])
    flat = torch.cat([flat, flat.new_zeros(1)])
    idx = wg_slab_index(flat.device)
    return flat[torch.where(idx < 0, flat.numel() - 1, idx)].reshape(
        len(wg_slab_plan()), SLAB_ROWS, SLAB_K).contiguous()


# The served float32 kernel's B units: 96 rows (output columns) × 32 TF32
# K values each, in wgmma's K-major layout with the 128-byte swizzle, the
# hi or the lo half (:func:`tf32_split`) of one K block; the stream in the
# order the kernel reads it (csrc/window_attention.cu).
F32_UNIT_ROWS, F32_UNIT_K = 96, 32
F32_RING_SLOTS, F32_UNIT_BYTES = 5, F32_UNIT_ROWS * F32_UNIT_K * 4


def f32_wg_unit_plan() -> list:
    """The float32 stream's units in order, each ``(matrix, first K row,
    first column, half)`` (half 0 hi, 1 lo): per head h its qkv columns
    96h.. (6 K blocks of 32, hi then lo each), then proj's ``wo`` rows
    32h.. (columns 0.., then 96..); then per hidden quarter q fc1's
    columns 96q.. (6 K blocks), fc2's ``w2`` rows 96q.. (per column half
    3 K blocks): 192 units, the first 96 window_attention's."""
    def kblocks(name, k0s, n0):
        return [(name, k0, n0, half) for k0 in k0s for half in (0, 1)]

    plan = []
    for h in range(6):
        plan += kblocks("wqkv", range(0, 192, 32), 96 * h)
        plan += [u for n0 in (0, 96) for u in kblocks("wo", [32 * h], n0)]
    for q in range(4):
        plan += kblocks("w1", range(0, 192, 32), 96 * q)
        plan += [u for n0 in (0, 96)
                 for u in kblocks("w2", range(96 * q, 96 * q + 96, 32), n0)]
    return plan


def f32_wg_unit_index(device=None) -> torch.Tensor:
    """For each float32 of the stream, (192, 96, 32) flattened, the flat
    index of the value it holds in ``cat([hi, lo])`` of :func:`tf32_split`
    of ``wqkv``, ``wo``, ``w1``, ``w2`` flattened (in, out) and concatenated
    in that order, −1 for a K pad (qkv and fc1's K 180 → 192, fc2's 360 →
    384): unit row n holds column n0 + n, its 16-byte chunk p the K rows
    k0 + 4 (p ^ (n % 8)) .. + 3 (:func:`_slab_index`)."""
    key = ("f32", str(device))
    if key not in _INDEX:
        _INDEX[key] = _slab_index(f32_wg_unit_plan(), 4).to(device)
    return _INDEX[key]


def pack_f32_wg_units(t: dict) -> torch.Tensor:
    """The float32 tables' ``wqkv``, ``wo``, ``w1``, ``w2`` as the served
    float32 kernel's stream of TF32 hi and lo units
    (:func:`f32_wg_unit_index`), (192, 96, 32) float32, K pads zero."""
    flat = torch.cat([t[k].float().reshape(-1) for k in WG_MATRICES])
    flat = torch.cat([*tf32_split(flat), flat.new_zeros(1)])
    idx = f32_wg_unit_index(flat.device)
    return flat[torch.where(idx < 0, flat.numel() - 1, idx)].reshape(
        len(f32_wg_unit_plan()), F32_UNIT_ROWS, F32_UNIT_K).contiguous()


def f32_wg_smem_plan() -> dict:
    """``swin_f32_wg_kernel``'s shared memory as
    ``csrc/window_attention.cu`` lays it out: up to 1024 to align, the
    ring, two windows (the float32 A buffer 64 × 192, then K and V^T of a
    head with their hi and lo copies: 81,920 each), the bias table
    [head][225] in float32, a full mbarrier and a release count a slot;
    ``total`` their sum."""
    plan = {"align": 1024, "ring": F32_RING_SLOTS * F32_UNIT_BYTES,
            "windows": 2 * (64 * 192 * 4 + 4 * 8192),
            "table": 6 * 225 * 4, "barriers": F32_RING_SLOTS * (8 + 4)}
    return {**plan, "total": sum(plan.values())}


def wg_smem_plan() -> dict:
    """``swin_wg_kernel``'s shared memory as ``csrc/window_attention.cu``
    lays it out: up to 1024 to align, the ring, two windows (LN, O, K, V:
    65,536 each), each window's tail of the next window's staged x (its
    tokens 45..63 at 360 bytes; 0..44 lie over K and V), the bias table
    [head][225] in float32, a full and an empty mbarrier a slot; ``total``
    their sum."""
    plan = {"align": 1024, "ring": RING_SLOTS * RING_SLOT_BYTES,
            "windows": 2 * (3 * 8192 + 3 * 8192 + 8192 + 8192),
            "x_tails": 2 * 6848,
            "table": 6 * 225 * 4, "barriers": 2 * RING_SLOTS * 8}
    return {**plan, "total": sum(plan.values())}


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
    - ``bias_table`` ((2w−1)², heads): the checkpoint's table in float32,
      which the served bf16 kernel reads at the tokens' offset;
    - ``masks`` (4, N, N): the shift-mask types (zeros when unshifted);
    - bf16 only, :data:`MMA_KEYS`: ``wqkv``, ``wo``, ``w1``, ``w2`` as B
      fragments (:func:`pack_mma_b`), K padded to cp (wqkv, w1), hp (w2);
      and at the kernel's configuration ``wg_slabs``, the same four as the
      served kernel's B slabs (:func:`pack_wg_slabs`);
    - float32 only, at the kernel's configuration: ``f32_units``, the four
      as the served float32 kernel's TF32 hi and lo units
      (:func:`pack_f32_wg_units`).
    A table that changes must be built again, so that both copies agree.
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

    t = {
        "g1": vec("norm1.weight", c), "b1": vec("norm1.bias", c),
        "wqkv": wqkv.reshape(c, -1).to(dtype).contiguous(),
        "bqkv": bqkv.reshape(-1).to(dtype).float().contiguous(),
        "wo": mat(wo.reshape(num_heads * dp, cp)),
        "bo": vec("attn.proj.bias", cp),
        "bias": bias.contiguous(),
        "bias_table": table.contiguous(),
        "masks": torch.from_numpy(masks).to(dev).contiguous(),
        "g2": vec("norm2.weight", c), "b2": vec("norm2.bias", c),
        "w1": mat(w1), "bf1": vec("mlp.fc1.bias", hp),
        "w2": mat(w2), "bf2": vec("mlp.fc2.bias", cp),
        "heads": num_heads, "head_dim": hd, "dp": dp, "dim": c,
        "hidden": hidden, "window": window, "shift": shift,
        "dtype": dtype,
    }
    if dtype == torch.bfloat16:
        kpad = {"wqkv": cp, "wo": num_heads * dp, "w1": cp, "w2": hp}
        for key, name in MMA_KEYS.items():
            t[key] = pack_mma_b(t[name], kpad[name])
        if all(tuple(t[k].shape) == s for k, s in WG_MATRICES.items()):
            t["wg_slabs"] = pack_wg_slabs(t)
    elif (dtype == torch.float32
          and all(tuple(t[k].shape) == s for k, s in WG_MATRICES.items())):
        t["f32_units"] = pack_f32_wg_units(t)
    return t


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


def _partition(x: torch.Tensor, window: int, shift: int,
               rolled: bool = False) -> torch.Tensor:
    """(B, H, W, C) → rolled windows (B·nW, N, C) float32 (``rolled``: H
    is rolled already)."""
    b, h, w, c = x.shape
    if shift:
        x = (torch.roll(x, -shift, 2) if rolled
             else torch.roll(x, (-shift, -shift), (1, 2)))
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c).float()


def _reverse(t: torch.Tensor, shape, window: int, shift: int,
             rolled: bool = False) -> torch.Tensor:
    b, h, w, _ = shape
    c = t.shape[-1]
    t = t.reshape(b, h // window, w // window, window, window, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift:
        t = (torch.roll(t, shift, 2) if rolled
             else torch.roll(t, (shift, shift), (1, 2)))
    return t.contiguous()


def _attention(xw: torch.Tensor, t: dict, shape, dtype,
               last: bool = True) -> torch.Tensor:
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
        types = torch.from_numpy(mask_type_index(h // window, w // window,
                                                 last))
        types = types.to(xw.device).repeat(b)
        s = s + t["masks"][types][:, None]
    p = _round(torch.softmax(s, -1), dtype)
    o = _round(p @ v, dtype)                         # (Bn, heads, N, dp)
    o = o.permute(0, 2, 1, 3).reshape(bn, n, heads * dp)
    return o @ t["wo"].float()


def window_attention_reference(x: torch.Tensor, t: dict, rolled: bool = False,
                               last: bool = True) -> torch.Tensor:
    """Plain version of :func:`window_attention`: (B, H, W, C) → the
    projected attention output (B, H, W, C) in ``x.dtype``, no residual."""
    dtype, c = x.dtype, t["dim"]
    xw = _partition(x, t["window"], t["shift"], rolled)
    out = _round(_attention(xw, t, x.shape, dtype, last) + t["bo"], dtype)
    return _reverse(out[..., :c], x.shape, t["window"], t["shift"],
                    rolled).to(dtype)


def swin_block_reference(x: torch.Tensor, t: dict, rolled: bool = False,
                         last: bool = True) -> torch.Tensor:
    """Plain version of :func:`swin_block`: (B, H, W, C) → same, in
    ``x.dtype``."""
    dtype, c, hidden = x.dtype, t["dim"], t["hidden"]
    xw = _partition(x, t["window"], t["shift"], rolled)
    y = xw + _attention(xw, t, x.shape, dtype, last)[..., :c] + t["bo"][:c]
    ln = layer_norm(y, t["g2"], t["b2"], dtype)
    hdn = _round(ln @ t["w1"].float() + t["bf1"], dtype)[..., :hidden]
    hdn = _round(gelu(hdn, dtype), dtype)
    mlp = hdn @ t["w2"].float() + t["bf2"]
    out = _round(y + mlp[..., :c], dtype)
    return _reverse(out, x.shape, t["window"], t["shift"], rolled).to(dtype)


# --- kernels ---------------------------------------------------------------

def _lib():
    from ._build import load

    lib = load("window_attention")
    if not getattr(lib, "_s2sr_typed", False):
        vp = ctypes.c_void_p
        lib.s2sr_swin_forward.argtypes = ([vp] * 20 + [ctypes.c_int] * 7
                                          + [vp])
        lib.s2sr_swin_forward.restype = ctypes.c_int
        lib.s2sr_swin_smem_bytes.argtypes = [ctypes.c_int]
        lib.s2sr_swin_smem_bytes.restype = ctypes.c_longlong
        lib.s2sr_swin_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.s2sr_swin_blocks_per_sm.restype = ctypes.c_int
        lib.s2sr_swin_macs_per_window.argtypes = [ctypes.c_int] * 2
        lib.s2sr_swin_macs_per_window.restype = ctypes.c_longlong
        lib.s2sr_swin_wg_forward.argtypes = ([vp] * 12 + [ctypes.c_int] * 7
                                             + [vp])
        lib.s2sr_swin_wg_forward.restype = ctypes.c_int
        lib.s2sr_swin_wg_smem_bytes.argtypes = []
        lib.s2sr_swin_wg_smem_bytes.restype = ctypes.c_longlong
        lib.s2sr_swin_wg_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.s2sr_swin_wg_blocks_per_sm.restype = ctypes.c_int
        ci = ctypes.c_int
        lib.s2sr_swin_f32_wg_forward.argtypes = [vp] * 12 + [ci] * 6 + [vp]
        lib.s2sr_swin_f32_wg_forward.restype = ci
        lib.s2sr_swin_f32_wg_smem_bytes.argtypes = []
        lib.s2sr_swin_f32_wg_smem_bytes.restype = ctypes.c_longlong
        lib.s2sr_swin_f32_wg_blocks_per_sm.argtypes = [ci]
        lib.s2sr_swin_f32_wg_blocks_per_sm.restype = ci
        lib.s2sr_swin_f32_wg_macs_per_window.argtypes = [ci]
        lib.s2sr_swin_f32_wg_macs_per_window.restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_tiling(dtype: torch.dtype, mlp: bool = True,
                  design: str = "served") -> dict:
    """The kernel's shared-memory bytes per block, its resident blocks per
    SM on the current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    and the multiply-adds it executes per 64-token window, pads included
    (float32's served kernel: each of its three TF32 products): the served
    kernel of ``dtype``, or ``design="mma"``'s (bf16) or ``"ffma"``'s
    (float32)."""
    if dtype == torch.float32 and design == "served":
        lib = _lib()
        blocks = int(lib.s2sr_swin_f32_wg_blocks_per_sm(int(mlp)))
        if blocks < 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {-blocks}")
        return {"smem_bytes": int(lib.s2sr_swin_f32_wg_smem_bytes()),
                "blocks_per_sm": blocks,
                "macs_per_window": int(lib.s2sr_swin_f32_wg_macs_per_window(
                    int(mlp)))}
    lib, code = _lib(), _DTYPE_CODE[dtype]
    wg = dtype == torch.bfloat16 and design != "mma"
    blocks = int(lib.s2sr_swin_wg_blocks_per_sm(int(mlp)) if wg
                 else lib.s2sr_swin_blocks_per_sm(code, int(mlp)))
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-blocks}")
    smem = (lib.s2sr_swin_wg_smem_bytes() if wg
            else lib.s2sr_swin_smem_bytes(code))
    return {"smem_bytes": int(smem), "blocks_per_sm": blocks,
            "macs_per_window": int(lib.s2sr_swin_macs_per_window(code,
                                                                 int(mlp)))}


# the tables' shapes at the kernel's configuration (C 180 → 192,
# 6 heads · 3 · 32 = 576 qkv columns, hidden 360 → 384)
_TABLE_SHAPES = {
    "g1": (180,), "b1": (180,), "wqkv": (180, 576), "bqkv": (576,),
    "wo": (192, 192), "bo": (192,), "bias": (6, 64, 64), "masks": (4, 64, 64),
    "g2": (180,), "b2": (180,), "w1": (180, 384), "bf1": (384,),
    "w2": (360, 192), "bf2": (192,),
}
_MATRICES = ("wqkv", "wo", "w1", "w2")
# the mma.sync design's B fragments (pack_mma_b), bf16
_MMA_SHAPES = {"wqkv_mma": (12, 72, 32, 4), "wo_mma": (12, 24, 32, 4),
               "w1_mma": (12, 48, 32, 4), "w2_mma": (24, 24, 32, 4)}
# the served bf16 kernel's B slabs (bf16) and bias table (float32)
_WG_SHAPES = {"wg_slabs": (48, SLAB_ROWS, SLAB_K), "bias_table": (225, 6)}
# the served float32 kernel's TF32 units and the bias table (float32)
_F32_SHAPES = {"f32_units": (192, F32_UNIT_ROWS, F32_UNIT_K),
               "bias_table": (225, 6)}


def _check(name: str, x: torch.Tensor, t: dict, design: str = "served") -> None:
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
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} wants a contiguous, 16-byte aligned NHWC "
                         f"tensor")
    if not 0 <= t["shift"] < cfg["window"]:
        raise ValueError(f"{name}: shift {t['shift']} out of range")
    shapes = dict(_TABLE_SHAPES)
    if x.dtype == torch.bfloat16:
        shapes.update(_MMA_SHAPES)
        shapes.update(_WG_SHAPES)
    elif design == "served":
        shapes.update(_F32_SHAPES)
    for key, shape in shapes.items():
        v = t.get(key)
        if v is None:
            raise ValueError(f"{name}: table {key} missing; build the tables "
                             f"with build_block_tables")
        want_dtype = (x.dtype if key in _MATRICES or key in _MMA_SHAPES
                      or key == "wg_slabs" else torch.float32)
        if (v.device != x.device or v.dtype != want_dtype
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"{name}: table {key} must be a contiguous "
                             f"{want_dtype} {shape} tensor on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _check_design(name: str, x: torch.Tensor, mlp: bool, design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(f"{name}: design {design!r} not in {DESIGNS}")
    if design in BF16_DESIGNS and x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: design {design!r} is a bfloat16 kernel, "
                        f"got {x.dtype}")
    if design == "ffma" and x.dtype != torch.float32:
        raise TypeError(f"{name}: design 'ffma' is a float32 kernel, got "
                        f"{x.dtype}")
    if design == "no_l2" and not mlp:
        raise ValueError(f"{name}: design 'no_l2' exists for swin_block only")


def _launch(name: str, x: torch.Tensor, t: dict, mlp: bool,
            rolled: bool = False, last: bool = True,
            design: str = "served") -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    _check_design(name, x, mlp, design)
    _check(name, x, t, design)
    bsz, h, w, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * w == 0:
        return out
    band = 0 if not rolled else 2 if last else 1
    f32 = x.dtype == torch.float32 and design == "served"
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if f32:
            rc = lib.s2sr_swin_f32_wg_forward(
                x.data_ptr(), out.data_ptr(),
                *(t[k].data_ptr() for k in ("g1", "b1", "bqkv", "bo",
                                            "bias_table", "g2", "b2", "bf1",
                                            "bf2", "f32_units")),
                bsz, h, w, t["shift"], int(mlp), band, stream)
        elif x.dtype == torch.bfloat16 and design != "mma":
            rc = lib.s2sr_swin_wg_forward(
                x.data_ptr(), out.data_ptr(),
                *(t[k].data_ptr() for k in ("g1", "b1", "bqkv", "bo",
                                            "bias_table", "g2", "b2", "bf1",
                                            "bf2", "wg_slabs")),
                bsz, h, w, t["shift"], int(mlp), band,
                int(design == "no_l2"), stream)
        else:
            frags = ([t[k].data_ptr() for k in MMA_KEYS]
                     if x.dtype == torch.bfloat16 else [None] * 4)
            rc = lib.s2sr_swin_forward(
                x.data_ptr(), out.data_ptr(),
                *(t[k].data_ptr() for k in ("g1", "b1", "wqkv", "bqkv", "wo",
                                            "bo", "bias", "masks", "g2", "b2",
                                            "w1", "bf1", "w2", "bf2")),
                *frags, bsz, h, w, t["shift"], _DTYPE_CODE[x.dtype], int(mlp),
                band, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    counts = {"served": LAUNCHES_F32 if f32 else LAUNCHES, "mma": LAUNCHES_MMA,
              "no_l2": LAUNCHES_NO_L2, "ffma": LAUNCHES_FFMA}[design]
    counts[name] += 1
    return out


def swin_block(x: torch.Tensor, t: dict, rolled: bool = False,
               last: bool = True, design: str = "served") -> torch.Tensor:
    """One whole Swin block, (B, H, W, C) → same, in ``x.dtype``, with
    ``t`` from :func:`build_block_tables`. ``rolled``: ``x`` is a band of
    H already rolled by ``-shift`` in H (W is rolled here), and ``last``
    says whether its last window row is the image's. CPU tensors run
    :func:`swin_block_reference`; CUDA tensors launch the kernel or raise.
    ``design`` (nothing served passes it): for bf16 ``"mma"`` launches the
    ``mma.sync`` design, ``"no_l2"`` the served kernel's instance that
    takes B from L2 only for its first six slabs (no defined output, no
    plain version); for float32 ``"ffma"`` the CUDA-core design."""
    if x.device.type == "cpu":
        if design == "no_l2":
            raise ValueError("swin_block: design 'no_l2' has no plain version")
        _check_design("swin_block", x, True, design)
        return swin_block_reference(x, t, rolled, last)
    return _launch("swin_block", x, t, True, rolled, last, design)


def window_attention(x: torch.Tensor, t: dict, rolled: bool = False,
                     last: bool = True, design: str = "served") -> torch.Tensor:
    """LN1 → window attention → proj, (B, H, W, C) → same, no residual;
    ``rolled``, ``last`` and ``design`` as :func:`swin_block`'s (``"mma"``
    and ``"ffma"`` only). CPU tensors run :func:`window_attention_reference`;
    CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        if design == "no_l2":
            raise ValueError("window_attention: design 'no_l2' exists for "
                             "swin_block only")
        _check_design("window_attention", x, False, design)
        return window_attention_reference(x, t, rolled, last)
    return _launch("window_attention", x, t, False, rolled, last, design)
