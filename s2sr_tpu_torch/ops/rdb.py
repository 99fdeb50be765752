"""Fused residual dense block: the hand-written Hopper kernel and its
plain PyTorch version.

Replaces ``s2sr_tpu/ops/pallas/fused_rdb_v4.py::rdb_pallas_v4``. The
function is ``s2sr_tpu/models/rrdbnet.py::_rdb_packed``: five 3×3 SAME
convs over the dense concat (64→32 ×4, →64), LeakyReLU 0.2,
``out = 0.2·x5 + x``, with an optional 0/1 mask that re-zeroes x1..x4
and the output (the exact masked-bucket serving path, which the TPU
kernel refused).

- :func:`rdb` is the wrapper. On a CUDA tensor it launches the kernel in
  ``csrc/rdb.cu`` (one launch per block, x1..x4 kept in shared memory;
  bf16 ``rdb_wg_kernel`` on ``wgmma`` with B streamed through a ring of
  bulk copies; float32 ``rdb_f32_wg_kernel``, the same design in split
  TF32: three TF32 products a multiply-add, so the sums keep float32's
  accuracy) or raises; on a CPU tensor it runs :func:`rdb_reference`.
- :data:`LAUNCHES` counts the bf16 kernel's launches, :data:`LAUNCHES_F32`
  the float32 kernel's, nothing else.
- What bounds the kernel on the H100 is operations (479,232 FLOP per
  pixel against 256 bytes per pixel in bf16); the source's header says
  what the design does about it.
- :func:`pack_rdb_wg` lays the packed weights out as the bf16 kernel's B
  slabs (:func:`slab_index_wg`), packed once a body (:func:`rdb` caches
  them by ``w``'s identity and version); :func:`rdb_wg_smem_plan` is its
  shared memory. :func:`pack_rdb_f32_wg` lays float32 weights out as the
  float32 kernel's hi and lo TF32 slabs (:func:`tf32_split`,
  :func:`slab_index_f32_wg`), cached the same way;
  :func:`rdb_f32_wg_smem_plan` is its shared memory.
- :func:`rdb_ffma` launches ``rdb_kernel<float>``, the float32 design
  before it (FFMA on the CUDA cores), which nothing served reaches: the
  baseline the float32 kernel is timed against; :data:`LAUNCHES_FFMA`
  counts its launches.
- :func:`rdb_mma` launches ``rdb_tc_kernel``, the bf16 design before it
  (``mma.sync``), which nothing served reaches: the RDB ladder's rung
  ``v4_mma``, so one call times both designs. :func:`pack_rdb_fragments`
  lays the packed weights out as its B fragments; :data:`LAUNCHES_MMA`
  counts its launches.
- :func:`rdb_i8` is the same block with its packed 64→192 x conv in int8
  (precision "int8", ``s2sr_tpu/models/rrdbnet_int8.py::_rdb_packed_mixed``):
  on a CUDA tensor ``rdb_i8_kernel`` (``wgmma``: s8 for x's rows, bf16
  for x1..x4's, B streamed through a ring by bulk copies), on a CPU
  tensor :func:`rdb_i8_reference`; :data:`LAUNCHES_I8` counts its
  launches, and :func:`pack_rdb_i8_fragments` and :func:`pack_rdb_i8_bf16`
  lay the int8 x conv and x1..x4's bf16 rows out as that kernel's B slabs.
- :func:`rdb_w8a8` is the block in full W8A8 (every conv input quantized,
  all five convs int8: ``rrdbnet_int8.py::_rdb_packed_i8``): on a CUDA
  tensor ``rdb_w8a8_kernel`` (the all-s8 instance of ``rdb_i8_kernel``'s
  design), on a CPU tensor :func:`rdb_w8a8_reference`;
  :data:`LAUNCHES_W8A8` counts its launches, and :func:`pack_rdb_w8a8`
  lays one quantized block (or a stack of them) out as that kernel's
  operands, once.
- :func:`rdb_ablated` launches the bf16 kernel's time-attribution
  instances (``rdb_wg_ablate_kernel``, the ports of ``rdb_pallas_v4``'s
  staging knobs, :data:`ABLATIONS`); only the RDB ladder
  (``bench/rdb_ladder.py``) and ``chip_smoke.py`` call it, nothing served.
  :func:`rdb_no_acc_reference` is the plain version of ``v4_no_acc``;
  :data:`LAUNCHES_ABLATED` counts their launches.
- :func:`prefix_kernels` is the packed prefix layout of the five convs
  (``rrdbnet.py::packed_prefix_kernels``), which every plain version here
  and the int8 quantizer read.

Weights travel packed: :func:`pack_rdb_weights` rounds the five conv
kernels and biases to the compute dtype (as the reference casts them)
and stores them as float32, kernels HWIO-flattened and concatenated.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

NF = 64
G = 32
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_MMA = 0
LAUNCHES_FFMA = 0
LAUNCHES_I8 = 0
LAUNCHES_W8A8 = 0
# the bf16 kernel's time-attribution instances by ladder variant: the codes
# of csrc/rdb.cu's enum Variant
ABLATIONS = {"v4_no_fill": 1, "v4_no_acc": 2, "v4_serialdma": 3}
LAUNCHES_ABLATED = dict.fromkeys(ABLATIONS, 0)
# columns of the packed 64 → 192 x conv, [a5|a4|a3|a2|a1]
WX_COLS = NF + 4 * G

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CIN = (NF, NF + G, NF + 2 * G, NF + 3 * G, NF + 4 * G)
_COUT = (G, G, G, G, NF)


def check_kernel_shapes(kernels) -> None:
    """Raise unless ``kernels`` are the five OIHW conv kernels of an RDB."""
    for k, (cin, cout) in enumerate(zip(_CIN, _COUT)):
        if tuple(kernels[k].shape) != (cout, cin, 3, 3):
            raise ValueError(f"conv{k + 1} kernel has shape "
                             f"{tuple(kernels[k].shape)}, want {(cout, cin, 3, 3)}")


def prefix_kernels(kernels, cin_dim: int = -2, cout_dim: int = -1) -> tuple:
    """The five per-source kernels of the packed prefix layout, from the
    five conv kernels of one RDB (``conv1`` .. ``conv5``, any width, input
    channels on ``cin_dim`` and output channels on ``cout_dim``: HWIO by
    default, ``(1, 0)`` for OIHW).

    Source j (x, then x1..x4) gets the slices of conv5 .. conv(j+1) that
    read it, concatenated over output channels in that order, so the
    accumulator reads ``[a5|a4|a3|a2|a1]`` and each stage consumes a
    G-lane tail: ``(wx, w1, w2, w3, w4)`` with ``wx`` 64 → 192 at the
    kernel's widths. The counterpart of
    ``s2sr_tpu/models/rrdbnet.py::packed_prefix_kernels``."""
    nf = kernels[0].shape[cin_dim]               # conv1 sees only x
    g = kernels[0].shape[cout_dim]
    srcs = [(0, nf)] + [(nf + (j - 1) * g, g) for j in range(1, 5)]
    return tuple(torch.cat([kernels[k - 1].narrow(cin_dim, lo, n)
                            for k in range(5, j, -1)], cout_dim)
                 for j, (lo, n) in enumerate(srcs))


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


def fragment_index(device=None) -> torch.Tensor:
    """Indices into :func:`pack_rdb_weights`' flat ``w`` that put it in
    ``rdb_tc_kernel``'s B-fragment order (``csrc/rdb.cu``; the ladder's
    ``v4_mma``).

    Stage s's im2col matrix has rows (source j, tap, channel) in the order
    the kernel walks its k16 slabs: sources x, x1, .. x_{s-1}, then the 9
    taps, then the source's channels; columns are the stage's output
    channels. Each (K_s, Cout_s) matrix of indices is laid out as
    ``mma.m16n8k16``'s B fragments, ``[K/16][Cout/16][lane][8]`` (lane
    ``4g + t``: rows 2t, 2t+1, 2t+8, 2t+9 of column g, then of column
    8 + g), and the stages follow one another."""
    key = str(device)
    if key not in _FRAG_INDEX:
        parts, off = [], 0
        for s, (cin, cout) in enumerate(zip(_CIN, _COUT), start=1):
            flat = torch.arange(9 * cin * cout).view(9, cin, cout) + off
            rows = []
            for j in range(s):
                lo, c = (0, NF) if j == 0 else (NF + (j - 1) * G, G)
                rows.append(flat[:, lo:lo + c].reshape(9 * c, cout))
            mat = torch.cat(rows)                           # (9·cin, cout)
            k, n = mat.shape
            parts.append(mat.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)
                         .permute(0, 4, 6, 2, 5, 1, 3).reshape(-1))
            off += 9 * cin * cout
        _FRAG_INDEX[key] = torch.cat(parts).to(device)
    return _FRAG_INDEX[key]


_FRAG_INDEX: dict = {}


def pack_rdb_fragments(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_rdb_weights`' flat float32 ``w`` as ``rdb_tc_kernel``'s
    B fragments (:func:`fragment_index`); exact, since ``w`` holds bf16
    values."""
    return w[fragment_index(w.device)].to(torch.bfloat16)


# --- the wgmma kernels' B slabs -----------------------------------------------

# the B ring of rdb_wg_kernel, rdb_i8_kernel and rdb_w8a8_kernel (csrc/rdb.cu
# KQ, NBUF, NBUF_BF16, SLOT): k-steps a slab (4 of 32 bytes of K a row),
# slots (the int8 kernels', rdb_wg's), bytes a slot (a slab at N 64)
KQ = 4
RING_SLOTS = 8
RING_SLOTS_BF16 = 3
RING_SLOT_BYTES = 64 * 128


def _smem_plan(slots: int, x_bytes: int, grow_bytes: int) -> dict:
    """A wgmma kernel's shared memory as ``csrc/rdb.cu`` lays it out
    (``wg_smem_bytes``): up to 1024 to align the ring, the ring of
    ``slots``, the sources x, x1..x4 over their regions (sides 26, 24, ..,
    18; x at ``x_bytes`` a value, x1..x4 at ``grow_bytes``), a full and an
    empty mbarrier a slot; ``total`` their sum."""
    sources = sum((16 + 2 * (5 - j)) ** 2
                  * (NF * x_bytes if j == 0 else G * grow_bytes)
                  for j in range(5))
    plan = {"align": 1024, "ring": slots * RING_SLOT_BYTES,
            "sources": sources, "barriers": 2 * slots * 8}
    return {**plan, "total": sum(plan.values())}


def wg_smem_plan(full: bool) -> dict:
    """Shared-memory bytes of ``rdb_i8_kernel`` (``full`` False: x in int8,
    x1..x4 in bf16) or ``rdb_w8a8_kernel`` (True: all in int8)."""
    return _smem_plan(RING_SLOTS, 1, 1 if full else 2)


def rdb_wg_smem_plan() -> dict:
    """Shared-memory bytes of ``rdb_wg_kernel``: every source in bf16, a
    ring of :data:`RING_SLOTS_BF16` slots."""
    return _smem_plan(RING_SLOTS_BF16, 2, 2)


# rdb_f32_wg_kernel (csrc/rdb.cu F32_NBUF, F32_UNIT): its 8×8 tile, slots of
# its ring, bytes a slot (one 8 KB unit of its stream), k-steps of 8 TF32
# values a tap of x and of x1..x4
F32_TILE = 8
F32_RING_SLOTS = 7
F32_UNIT_BYTES = 8192
F32_STEPS_PER_TAP = (NF // 8, G // 8)


def rdb_f32_wg_smem_plan() -> dict:
    """Shared-memory bytes of ``rdb_f32_wg_kernel`` as ``csrc/rdb.cu``
    lays it out (``f32_smem_bytes``): up to 1024 to align the ring, its
    :data:`F32_RING_SLOTS` slots of 8 KB, the sources x, x1..x4 in float32
    over the 8×8 tile's regions (sides 18, 16, .., 10: 172,032 bytes, as
    ``rdb_kernel<float>``'s), a full and an empty mbarrier a slot;
    ``total`` their sum (230,512 of the block's 232,448)."""
    sources = sum((F32_TILE + 2 * (5 - j)) ** 2 * (NF if j == 0 else G) * 4
                  for j in range(5))
    plan = {"align": 1024, "ring": F32_RING_SLOTS * F32_UNIT_BYTES,
            "sources": sources, "barriers": 2 * F32_RING_SLOTS * 8}
    return {**plan, "total": sum(plan.values())}


def _slabs(steps: torch.Tensor) -> torch.Tensor:
    """One part's rows of B as the int8 kernels' ring holds them.

    ``steps`` (n_steps, N, 32): for each k-step and output channel n, the
    indices of its 32 bytes of K in a source byte array (−1: none). The
    steps are padded with −1 to whole slabs of :data:`KQ`; each slab is N
    rows of 128 bytes, row n its KQ k-steps side by side, in ``wgmma``'s
    K-major layout with the 128-byte swizzle: logical 16-byte chunk c of
    row n stored at chunk c ^ (n % 8). Returns the flat index array."""
    n_steps, n, _ = steps.shape
    nsl = -(-n_steps // KQ)
    pad = steps.new_full((nsl * KQ - n_steps, n, 32), -1)
    rows = torch.cat([steps, pad]).reshape(nsl, KQ, n, 32).permute(0, 2, 1, 3)
    rows = rows.reshape(nsl, n, 8, 16)
    # physical chunk p of row n holds logical chunk p ^ (n % 8)
    chunk = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)
    return torch.gather(rows, 2, chunk[None, :, :, None].expand(nsl, n, 8, 16)
                        ).reshape(-1)


def _s8_steps(j: int, s: int, cols: int, off: int = 0) -> torch.Tensor:
    """k-steps of s8 source j (x: 64 channels, two a tap; x_j: 32, one a
    tap) for stage s, as indices into an HWIO int8 kernel (3, 3, Cin_j,
    cols) flattened from ``off``: stage s's columns from
    :func:`_stage_col`, 32 channels a step."""
    cin = NF if j == 0 else G
    spt = cin // 32
    k = torch.arange(9 * spt)
    ch = 32 * (k % spt)[:, None] + torch.arange(32)[None, :]       # (steps, 32)
    n = torch.arange(_COUT[s - 1])
    return (off + ((k // spt)[:, None, None] * cin + ch[:, None, :]) * cols
            + _stage_col(s) + n[None, :, None])


def _bf16_steps(j: int, s: int) -> torch.Tensor:
    """The k-steps of bf16 source j for stage s (x: 64 channels, four a
    tap, rdb_wg's; x1..x4: 32, two a tap, rdb_wg's and rdb_i8's), as byte
    indices into :func:`pack_rdb_weights`' flat ``w`` in bf16 (two bytes a
    value, low byte first): conv s's rows of source j's channels, tap by
    tap, 16 values a step."""
    cin, cout = _CIN[s - 1], _COUT[s - 1]
    off = sum(9 * ci * co for ci, co in zip(_CIN[:s - 1], _COUT[:s - 1]))
    lo, spt = (0, NF // 16) if j == 0 else (NF + (j - 1) * G, G // 16)
    k = torch.arange(9 * spt)
    ch = lo + 16 * (k % spt)[:, None] + torch.arange(16)[None, :]
    val = (off + ((k // spt)[:, None, None] * cin + ch[:, None, :]) * cout
           + torch.arange(cout)[None, :, None])                  # (steps, cout, 16)
    return torch.stack([2 * val, 2 * val + 1], -1).reshape(9 * spt, cout, 32)


def slab_index_i8(device=None) -> torch.Tensor:
    """Indices into the flattened HWIO int8 x conv (3, 3, 64, 192), whose
    columns are ``[a5|a4|a3|a2|a1]``, that give ``rdb_i8_kernel``'s stream
    ``wq`` (−1: a padding byte): per stage, the 18 k-steps of x's rows at
    the stage's columns (tap, then 32 of the 64 channels), as
    :func:`_slabs` lays them out, the stages one after another."""
    key = ("i8", str(device))
    if key not in _SLAB_INDEX:
        _SLAB_INDEX[key] = torch.cat([_slabs(_s8_steps(0, s, WX_COLS))
                                      for s in range(1, 6)]).to(device)
    return _SLAB_INDEX[key]


def slab_index_i8_bf16(device=None) -> torch.Tensor:
    """Byte indices into :func:`pack_rdb_weights`' ``w`` in bf16 that give
    ``rdb_i8_kernel``'s stream ``wf`` (−1: a padding byte): per stage 2..5,
    the k-steps of x1..x_{s-1}'s rows in order (18 each: tap, then 16 of
    the 32 channels), as :func:`_slabs` lays them out."""
    key = ("bf16", str(device))
    if key not in _SLAB_INDEX:
        _SLAB_INDEX[key] = torch.cat([
            _slabs(torch.cat([_bf16_steps(j, s) for j in range(1, s)]))
            for s in range(2, 6)]).to(device)
    return _SLAB_INDEX[key]


def slab_index_wg(device=None) -> torch.Tensor:
    """Byte indices into :func:`pack_rdb_weights`' ``w`` in bf16 that give
    ``rdb_wg_kernel``'s stream (−1: a padding byte): per stage, one part,
    the k-steps of x's rows (36: tap, then 16 of the 64 channels) and then
    of x1..x_{s-1}'s (18 each), as :func:`_slabs` lays them out, the
    stages one after another: every weight's two bytes once."""
    key = ("wg", str(device))
    if key not in _SLAB_INDEX:
        _SLAB_INDEX[key] = torch.cat([
            _slabs(torch.cat([_bf16_steps(j, s) for j in range(s)]))
            for s in range(1, 6)]).to(device)
    return _SLAB_INDEX[key]


def _f32_steps(j: int, s: int) -> torch.Tensor:
    """The k-steps of source j for stage s in the float32 kernel (8
    channels of one tap: x's 72, x1..x4's 36 each), as byte indices into
    :func:`pack_rdb_weights`' flat float32 ``w`` (four bytes a value):
    ``(steps, cout, 32)``, as :func:`_slabs` takes them."""
    cin, cout = _CIN[s - 1], _COUT[s - 1]
    off = sum(9 * ci * co for ci, co in zip(_CIN[:s - 1], _COUT[:s - 1]))
    lo = 0 if j == 0 else NF + (j - 1) * G
    spt = F32_STEPS_PER_TAP[j > 0]
    k = torch.arange(9 * spt)
    ch = lo + 8 * (k % spt)[:, None] + torch.arange(8)[None, :]
    val = (off + ((k // spt)[:, None, None] * cin + ch[:, None, :]) * cout
           + torch.arange(cout)[None, :, None])                  # (steps, cout, 8)
    return (4 * val[..., None] + torch.arange(4)).reshape(9 * spt, cout, 32)


def slab_index_f32_wg(device=None) -> torch.Tensor:
    """Byte indices into ``cat([hi, lo])`` of :func:`tf32_split` of
    :func:`pack_rdb_weights`' flat float32 ``w`` that give
    ``rdb_f32_wg_kernel``'s stream: 8 KB units in the order the kernel
    reads them. Per stage, slabs of :data:`KQ` k-steps (x's 72, then
    x1..x_{s-1}'s 36 each; 8 channels of one tap a k-step) laid out by
    :func:`_slabs`, each followed by its lo slab: a stage 1-4 slab pair (32
    rows) is one unit, a stage 5 pair (64 rows) two. Every weight's hi and
    lo once; no padding."""
    key = ("f32", str(device))
    if key not in _SLAB_INDEX:
        n_bytes = 4 * sum(9 * ci * co for ci, co in zip(_CIN, _COUT))
        units = []
        for s, cout in enumerate(_COUT, start=1):
            hi = _slabs(torch.cat([_f32_steps(j, s) for j in range(s)]))
            hi = hi.reshape(-1, cout * 128)
            units.append(torch.stack([hi, hi + n_bytes], 1).reshape(-1))
        _SLAB_INDEX[key] = torch.cat(units).to(device)
    return _SLAB_INDEX[key]


_SLAB_INDEX: dict = {}


def tf32_split(t: torch.Tensor) -> tuple:
    """float32 ``t`` as ``(hi, lo)``: ``hi`` rounded to TF32 (10 stored
    mantissa bits) to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``, by adding half of the dropped 13 bits' range to
    the bit pattern and clearing them; ``lo`` = the same rounding of ``t −
    hi`` (exact in float32). ``hi + lo`` is ``t`` within 2⁻²² of it."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    t = t.float()
    hi = rna(t)
    return hi, rna(t - hi)


def _gather(flat: torch.Tensor, index) -> torch.Tensor:
    """``flat[..., index()]`` with a zero wherever the index is −1."""
    key = (index.__name__, str(flat.device))
    if key not in _RESOLVED:
        idx = index(flat.device)
        _RESOLVED[key] = torch.where(idx < 0, flat.shape[-1], idx)
    flat = torch.cat([flat, flat.new_zeros(*flat.shape[:-1], 1)], -1)
    return flat[..., _RESOLVED[key]].contiguous()


# _gather's indices with −1 resolved to the appended zero, by index and
# device
_RESOLVED: dict = {}


def pack_rdb_i8_fragments(wx8: torch.Tensor) -> torch.Tensor:
    """The int8 x conv, HWIO (3, 3, 64, 192) with columns ``[a5|..|a1]``
    (``rrdbnet_int8.py::quantize_body_mixed``'s ``wx8``), as
    ``rdb_i8_kernel``'s s8 B slabs (:func:`slab_index_i8`), flat int8."""
    if tuple(wx8.shape) != (3, 3, NF, WX_COLS) or wx8.dtype != torch.int8:
        raise ValueError(f"wx8 must be int8 (3, 3, {NF}, {WX_COLS}), got "
                         f"{wx8.dtype} {tuple(wx8.shape)}")
    return _gather(wx8.reshape(-1), slab_index_i8)


def pack_rdb_i8_bf16(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_rdb_weights`' flat float32 ``w`` (bf16 values) as
    ``rdb_i8_kernel``'s bf16 B slabs of x1..x4's rows
    (:func:`slab_index_i8_bf16`), flat uint8; exact."""
    raw = w.to(torch.bfloat16).view(torch.uint8)
    return _gather(raw, slab_index_i8_bf16)


def pack_rdb_wg(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_rdb_weights`' flat float32 ``w`` (bf16 values) as
    ``rdb_wg_kernel``'s bf16 B slabs (:func:`slab_index_wg`), flat uint8;
    exact."""
    return _gather(w.to(torch.bfloat16).view(torch.uint8), slab_index_wg)


def pack_rdb_f32_wg(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_rdb_weights`' flat float32 ``w`` as
    ``rdb_f32_wg_kernel``'s stream of hi and lo TF32 slabs
    (:func:`tf32_split`, :func:`slab_index_f32_wg`), flat uint8."""
    return _gather(torch.cat(tf32_split(w)).view(torch.uint8), slab_index_f32_wg)


def quant_i8(x: torch.Tensor, qm) -> torch.Tensor:
    """``rrdbnet_int8.py::_quant`` as float32 integer values:
    ``round(x·qm)`` (half to even, in float32), clamped to ±127."""
    qm = torch.as_tensor(qm, dtype=torch.float32, device=x.device)
    return torch.round(x.float() * qm).clamp_(-127, 127)


def conv_i8_gemm(x8: torch.Tensor, wx8: torch.Tensor) -> torch.Tensor:
    """The int8 conv as an int8 GEMM with int32 sums (``torch._int_mm``):
    NCHW integer-valued ``x8`` gathered to ``(pixels, 9·Cin)`` int8 rows
    (tap-major, the zero border of SAME padding included) against the
    OIHW ``wx8`` as ``(9·Cin, Cout)`` int8 → NCHW int32. Rows are padded
    to at least 32 for the GEMM's shape rule and sliced back."""
    b, cin, h, w = x8.shape
    xp = F.pad(x8.to(torch.int8).permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    rows = torch.cat([xp[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], -1)
    rows = rows.reshape(b * h * w, 9 * cin)
    n = rows.shape[0]
    if n < 32:
        rows = torch.cat([rows, rows.new_zeros(32 - n, 9 * cin)])
    wmat = wx8.to(torch.int8).permute(2, 3, 1, 0).reshape(9 * cin, -1)
    out = torch._int_mm(rows.contiguous(), wmat.contiguous())[:n]
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def conv_i8_int(x8: torch.Tensor, wx8: torch.Tensor) -> torch.Tensor:
    """The int8 conv's exact int32-valued sums, as float32: NCHW
    integer-valued ``x8`` with OIHW ``wx8``. On a CUDA tensor an int8 GEMM
    on the tensor cores (:func:`conv_i8_gemm`, XLA's int8 conv in the JAX
    package); on the CPU a float32 conv of the integer values: every
    partial sum is an integer with |sum| ≤ 127²·576 < 2²⁴, so float32
    adds it exactly in any order (TF32 kept off). Both are exact, so they
    agree bit for bit."""
    from ..utils.precision import ieee_fp32

    if x8.device.type == "cuda":
        return conv_i8_gemm(x8, wx8).float()
    with ieee_fp32():
        return F.conv2d(x8.float(), wx8.float(), padding=1)


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

    def conv(t, kernel):
        return F.conv2d(t, kernel, padding=1)

    wx, w1, w2, w3, w4 = prefix_kernels(ks, 1, 0)
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


def rdb_no_acc_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the ablation ``v4_no_acc``, (B, H, W, 64) → same,
    in ``x.dtype``: what ``rdb_pallas_v4(..., ablate="no_acc")`` computes,
    whose stages overwrite the accumulator instead of adding to it. Each
    stage reads the previous source alone: x1 from x, x(k+1) from xk
    (conv k+1's slice of xk's channels), x5 from x4, then
    ``out = m(0.2·(x5 + b5) + x)``; bias, LeakyReLU and the mask as in
    :func:`rdb_reference`. Not an RDB: a time attribution whose math is
    wrong on purpose."""
    dtype = x.dtype
    ks, bs = unpack_rdb_weights(w, b)
    xc = x.permute(0, 3, 1, 2)
    mk = _mask_nchw(mask, x)
    slope = torch.tensor(0.2, dtype=dtype, device=x.device)
    t = xc
    for k in range(1, 6):
        lo = 0 if k == 1 else NF + (k - 2) * G          # source k-1's channels
        kernel = ks[k - 1][:, lo:lo + t.shape[1]].to(dtype)
        v = F.conv2d(t, kernel, padding=1) + bs[k - 1].to(dtype).view(1, -1, 1, 1)
        if k < 5:
            v = torch.where(v >= 0, v, v * slope)
            t = v if mk is None else v * mk
    out = v * slope + xc
    out = out if mk is None else out * mk
    return out.permute(0, 2, 3, 1).contiguous()


def rdb_i8_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     wx8: torch.Tensor, deq: torch.Tensor, qm,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the int8-mixed block (``_rdb_packed_mixed``
    of the JAX package), (B, H, W, 64) → same, in ``x.dtype``.

    x is quantized with ``qm``, the packed 64→192 x conv (``wx8``, int8
    HWIO) runs on the int8 values (:func:`conv_i8_int`) and is dequantized
    by ``deq[col]`` into ``x.dtype``; x1..x4's convs, biases, LeakyReLU,
    mask and residual are :func:`rdb_reference`'s, from the float weights
    ``w``, ``b``."""
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

    def conv(t, kernel):
        return F.conv2d(t, kernel, padding=1)

    prod = conv_i8_int(quant_i8(xc, qm), wx8.permute(3, 2, 0, 1))  # OIHW
    acc = (prod * deq.float().view(1, -1, 1, 1)).to(dtype)   # [a5|..|a1]
    _, w1, w2, w3, w4 = prefix_kernels(ks, 1, 0)
    x1 = m(lrelu(acc[:, -G:] + bs[0]))
    acc = acc[:, :-G] + conv(x1, w1)
    x2 = m(lrelu(acc[:, -G:] + bs[1]))
    acc = acc[:, :-G] + conv(x2, w2)
    x3 = m(lrelu(acc[:, -G:] + bs[2]))
    acc = acc[:, :-G] + conv(x3, w3)
    x4 = m(lrelu(acc[:, -G:] + bs[3]))
    x5 = acc[:, :-G] + conv(x4, w4) + bs[4]
    out = m(x5 * slope + xc)
    return out.permute(0, 2, 3, 1).contiguous()


def rdb_w8a8_reference(x: torch.Tensor, qp: dict,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the full-W8A8 block (``_rdb_packed_i8`` of
    the JAX package), (B, H, W, 64) → same, in ``x.dtype``.

    ``qp``: one RDB of ``rrdbnet_int8.quantize_body`` on ``x``'s device:
    ``w8`` the five int8 packed HWIO kernels (:func:`prefix_kernels`),
    ``deq`` their dequantization factors, ``qm`` (5,) the inverse
    activation scales of x, x1..x4, ``b`` the five float32 biases.
    ``mask``: None or 0/1 of shape (B, H, W) or (B, H, W, 1).

    As in JAX, per stage: the int8 conv's exact sums (:func:`conv_i8_int`)
    times ``deq`` in float32, rounded to ``x.dtype``; the prefix
    accumulator in ``x.dtype``; bias, LeakyReLU and the mask, then the
    quantization of x1..x4; ``x5 = (acc + conv) + bias``; ``out =
    m(x5·0.2 + x)``."""
    dtype = x.dtype
    w8, deq, qm, b = qp["w8"], qp["deq"], qp["qm"], qp["b"]
    g = w8[4].shape[2]
    mk = None if mask is None else mask.reshape(*x.shape[:3], 1).to(dtype)
    slope = torch.tensor(0.2, dtype=dtype, device=x.device)

    def m(t):
        return t if mk is None else t * mk

    def lrelu(t):
        return torch.where(t >= 0, t, t * slope)

    def conv(t, k):
        # the int8 values of NHWC t with source k's kernel, dequantized
        out = conv_i8_int(quant_i8(t, qm[k]).permute(0, 3, 1, 2),
                          w8[k].permute(3, 2, 0, 1))
        return (out.permute(0, 2, 3, 1) * deq[k].float()).to(dtype)

    acc = conv(x, 0)                                     # [a5|a4|a3|a2|a1]
    for k in range(1, 5):
        xk = m(lrelu(acc[..., -g:] + b[k - 1].to(dtype)))
        acc = acc[..., :-g] + conv(xk, k)
    x5 = acc + b[4].to(dtype)
    return m(x5 * slope + x)


def _lib():
    from ._build import load

    lib = load("rdb")
    if not getattr(lib, "_s2sr_typed", False):
        vp = ctypes.c_void_p
        lib.s2sr_rdb_forward.argtypes = [vp, vp, vp, vp, vp,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, vp]
        lib.s2sr_rdb_forward.restype = ctypes.c_int
        lib.s2sr_rdb_mma_forward.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int, vp]
        lib.s2sr_rdb_mma_forward.restype = ctypes.c_int
        lib.s2sr_rdb_ffma_forward.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, vp]
        lib.s2sr_rdb_ffma_forward.restype = ctypes.c_int
        lib.s2sr_rdb_i8_forward.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, vp]
        lib.s2sr_rdb_i8_forward.restype = ctypes.c_int
        lib.s2sr_rdb_w8a8_forward.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, vp]
        lib.s2sr_rdb_w8a8_forward.restype = ctypes.c_int
        lib.s2sr_rdb_ablate_forward.argtypes = [vp, vp, vp, vp, vp,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_int, vp]
        lib.s2sr_rdb_ablate_forward.restype = ctypes.c_int
        for name in ("s2sr_rdb_i8_smem_bytes", "s2sr_rdb_w8a8_smem_bytes",
                     "s2sr_rdb_i8_macs_per_tile", "s2sr_rdb_mma_smem_bytes",
                     "s2sr_rdb_mma_macs_per_tile", "s2sr_rdb_ffma_smem_bytes",
                     "s2sr_rdb_ffma_macs_per_tile"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_longlong
        lib.s2sr_rdb_tile.argtypes = [ctypes.c_int]
        lib.s2sr_rdb_tile.restype = ctypes.c_int
        for name in ("s2sr_rdb_smem_bytes", "s2sr_rdb_macs_per_tile"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_tiling(dtype: torch.dtype) -> dict:
    """The kernel's output tile side, shared-memory bytes per block and
    multiply-adds executed per tile (halo recompute included): bf16
    ``rdb_wg_kernel``, or float32 ``rdb_f32_wg_kernel`` (those of each of
    its three TF32 products)."""
    lib = _lib()
    code = _DTYPE_CODE[dtype]
    return {"tile": int(lib.s2sr_rdb_tile(code)),
            "smem_bytes": int(lib.s2sr_rdb_smem_bytes(code)),
            "macs_per_tile": int(lib.s2sr_rdb_macs_per_tile(code))}


def kernel_tiling_ffma() -> dict:
    """:func:`kernel_tiling` of ``rdb_kernel<float>`` (:func:`rdb_ffma`):
    the float32 kernel's 8×8 tile; its shared memory (the sources planar in
    float32) and the multiply-adds of its warp tasks."""
    lib = _lib()
    return {**kernel_tiling(torch.float32),
            "smem_bytes": int(lib.s2sr_rdb_ffma_smem_bytes()),
            "macs_per_tile": int(lib.s2sr_rdb_ffma_macs_per_tile())}


def kernel_tiling_mma() -> dict:
    """:func:`kernel_tiling` of ``rdb_tc_kernel`` (``v4_mma``): the same
    tile; its shared memory (x and x1..x4 in bf16) and the multiply-adds
    of its 16-row M tiles."""
    lib = _lib()
    return {**kernel_tiling(torch.bfloat16),
            "smem_bytes": int(lib.s2sr_rdb_mma_smem_bytes()),
            "macs_per_tile": int(lib.s2sr_rdb_mma_macs_per_tile())}


def _check(x, w, b, mask):
    _check_x(x, mask)
    n_w = sum(9 * ci * co for ci, co in zip(_CIN, _COUT))
    for name, t, n in (("w", w, n_w), ("b", b, sum(_COUT))):
        if (t.device != x.device or t.dtype != torch.float32
                or t.dim() != 1 or t.numel() != n or not t.is_contiguous()):
            raise ValueError(f"rdb packed {name} must be a contiguous float32 "
                             f"vector of {n} on {x.device}")


def _check_x(x, mask):
    if x.dim() != 4 or x.shape[-1] != NF:
        raise ValueError(f"rdb wants (B, H, W, {NF}), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rdb supports float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rdb wants a contiguous NHWC tensor")
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
    kernel of their dtype (bf16 ``rdb_wg_kernel``, float32
    ``rdb_f32_wg_kernel``) or raise."""
    global LAUNCHES, LAUNCHES_F32
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
    # both kernels read their weights as B slabs, packed once a body
    f32 = x.dtype == torch.float32
    wf = (_packed(_F32_PACKS, w, pack_rdb_f32_wg) if f32
          else _packed(_WG_PACKS, w, pack_rdb_wg))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), wf.data_ptr(), b.data_ptr(), bsz, h, wd,
            _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rdb kernel launch failed: CUDA error {rc}")
    if f32:
        LAUNCHES_F32 += 1
    else:
        LAUNCHES += 1
    return out


# the kernels' weights by ``w``: packed on first use, again only when
# ``w`` was changed in place (its version) or is another tensor
_WG_PACKS = WeakIdKeyDictionary()
_F32_PACKS = WeakIdKeyDictionary()
_MMA_PACKS = WeakIdKeyDictionary()


def _packed(cache, t: torch.Tensor, pack) -> torch.Tensor:
    """``pack(t)``, packed once a body: a block's weights stay the same
    tensors from launch to launch. ``cache`` maps ``t`` (weakly) to its
    version and packing."""
    hit = cache.get(t)
    if hit is not None and hit[0] == t._version:
        return hit[1]
    packed = pack(t)
    cache[t] = (t._version, packed)
    return packed


def rdb_mma(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """One RDB through ``rdb_tc_kernel``, the bf16 design on ``mma.sync``
    that :func:`rdb` served before ``rdb_wg_kernel``: the RDB ladder's
    rung ``v4_mma``. Nothing served calls it. Operands as :func:`rdb`'s.
    On a CUDA tensor it launches the kernel or raises (bfloat16 only); on
    a CPU tensor it runs :func:`rdb_reference`."""
    global LAUNCHES_MMA
    if x.device.type == "cpu":
        return rdb_reference(x, w, b, mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_mma: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rdb_mma's kernel takes bfloat16, got {x.dtype}")
    _check(x, w, b, mask)
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    lib = _lib()
    wf = _packed(_MMA_PACKS, w, pack_rdb_fragments)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_mma_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), wf.data_ptr(), b.data_ptr(), bsz, h, wd, stream)
    if rc != 0:
        raise RuntimeError(f"rdb_mma kernel launch failed: CUDA error {rc}")
    LAUNCHES_MMA += 1
    return out


def rdb_ffma(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """One RDB through ``rdb_kernel<float>``, the float32 design on the
    CUDA cores (FFMA) that :func:`rdb` served before ``rdb_f32_wg_kernel``:
    the baseline the float32 kernel is timed against. Nothing served calls
    it. Operands as :func:`rdb`'s. On a CUDA tensor it launches the kernel
    or raises (float32 only); on a CPU tensor it runs
    :func:`rdb_reference`."""
    global LAUNCHES_FFMA
    if x.device.type == "cpu":
        return rdb_reference(x, w, b, mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_ffma: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"rdb_ffma's kernel takes float32, got {x.dtype}")
    _check(x, w, b, mask)
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_ffma_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz, h, wd, stream)
    if rc != 0:
        raise RuntimeError(f"rdb_ffma kernel launch failed: CUDA error {rc}")
    LAUNCHES_FFMA += 1
    return out


def rdb_ablated(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                variant: str, mask: torch.Tensor | None = None) -> torch.Tensor:
    """One RDB through a time-attribution instance of the bf16 kernel
    (``variant``, a key of :data:`ABLATIONS`), (B, H, W, 64) → same.

    Only the RDB ladder and ``chip_smoke.py`` call this; nothing served
    does. Operands as :func:`rdb`'s. On a CUDA tensor it launches
    ``rdb_wg_ablate_kernel`` or raises (bfloat16 only). On a CPU tensor it
    runs the plain version of the variant's function: :func:`rdb_reference`
    for ``v4_serialdma`` (the served math),
    :func:`rdb_no_acc_reference` for ``v4_no_acc``; ``v4_no_fill`` has no
    defined output and raises."""
    if variant not in ABLATIONS:
        raise ValueError(f"unknown ablation {variant!r}: {sorted(ABLATIONS)}")
    if x.device.type == "cpu":
        if variant == "v4_no_fill":
            raise ValueError("v4_no_fill reads shared memory that nothing "
                             "wrote: it has no defined output, so no plain "
                             "version; it runs only on the card")
        if variant == "v4_no_acc":
            return rdb_no_acc_reference(x, w, b, mask)
        return rdb_reference(x, w, b, mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_ablated: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rdb_ablated's kernel takes bfloat16, got {x.dtype}")
    _check(x, w, b, mask)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch_ablated(_lib(), x, _packed(_WG_PACKS, w, pack_rdb_wg), b,
                        mask, out, variant, stream)
    return out


def _launch_ablated(lib, x, wf, b, mask, out, variant: str, stream) -> None:
    """``s2sr_rdb_ablate_forward`` of ``lib`` with the variant's code;
    counts the launch in :data:`LAUNCHES_ABLATED`."""
    bsz, h, wd, _ = x.shape
    rc = lib.s2sr_rdb_ablate_forward(
        x.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), wf.data_ptr(), b.data_ptr(), bsz, h, wd,
        ABLATIONS[variant], stream)
    if rc != 0:
        raise RuntimeError(f"rdb_ablated({variant}) kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES_ABLATED[variant] += 1


# rdb_i8's slab streams, by the tensor each is packed from (as _packed)
_I8_PACKS = WeakIdKeyDictionary()
_I8_BF16_PACKS = WeakIdKeyDictionary()


def kernel_tiling_i8() -> dict:
    """:func:`kernel_tiling` of ``rdb_i8_kernel``: the bf16 kernel's tile;
    its shared memory (the B ring, x in int8, x1..x4 in bf16) and the
    multiply-adds of its 64-row M tiles."""
    lib = _lib()
    return {**kernel_tiling(torch.bfloat16),
            "smem_bytes": int(lib.s2sr_rdb_i8_smem_bytes()),
            "macs_per_tile": int(lib.s2sr_rdb_i8_macs_per_tile())}


def rdb_i8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           wx8: torch.Tensor, deq: torch.Tensor, qm,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """One residual dense block with its x conv in int8, (B, H, W, 64) →
    same, in ``x.dtype``.

    ``w``, ``b``: :func:`pack_rdb_weights` output (the float convs of
    x1..x4); ``wx8``: the int8 x conv, HWIO (3, 3, 64, 192) with columns
    ``[a5|..|a1]``; ``deq``: its 192 float32 dequantization factors in
    packed column order; ``qm``: x's quantization multiplier (a float).
    CPU tensors run :func:`rdb_i8_reference`; CUDA tensors launch
    ``rdb_i8_kernel`` or raise (it takes bfloat16 only)."""
    global LAUNCHES_I8
    if x.device.type == "cpu":
        return rdb_i8_reference(x, w, b, wx8, deq, qm, mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_i8: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rdb_i8's kernel takes bfloat16, got {x.dtype}")
    _check(x, w, b, mask)
    if wx8.device != x.device:
        raise ValueError(f"rdb_i8 wx8 must be on {x.device}")
    if (deq.device != x.device or deq.dtype != torch.float32
            or deq.numel() != WX_COLS or not deq.is_contiguous()):
        raise ValueError(f"rdb_i8 deq must be {WX_COLS} contiguous float32 "
                         f"on {x.device}")
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    lib = _lib()
    wq = _packed(_I8_PACKS, wx8, pack_rdb_i8_fragments)
    wf = _packed(_I8_BF16_PACKS, w, pack_rdb_i8_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_i8_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), wf.data_ptr(), wq.data_ptr(),
            deq.data_ptr(), b.data_ptr(), float(qm), bsz, h, wd, stream)
    if rc != 0:
        raise RuntimeError(f"rdb_i8 kernel launch failed: CUDA error {rc}")
    LAUNCHES_I8 += 1
    return out


# --- full W8A8 ---------------------------------------------------------------

# input channels of source j's packed int8 kernel (x, then x1..x4)
_W8_CIN = (NF, G, G, G, G)


def _w8_cols(j: int) -> int:
    """Output columns of source j's packed kernel: ``[a5|..|a(j+1)]``."""
    return WX_COLS - j * G


def _stage_col(s: int) -> int:
    """Column of stage s's output channel 0 in every source's packed
    kernel (the columns run a5, a4, .. in each)."""
    return 0 if s == 5 else NF + (4 - s) * G


def slab_index_w8a8(device=None) -> torch.Tensor:
    """Indices into the five int8 packed kernels (``w8``, HWIO, flattened
    and concatenated in source order) that give ``rdb_w8a8_kernel``'s
    stream ``wq`` (−1: a padding byte).

    Stage s reads from each source j < s the columns of its own output
    channels (:func:`_stage_col`, the same in every source's kernel), as
    k-steps of 32 channels: 18 for x (two a tap), 9 for x1..x4. A stage's
    sources follow one another as one part, laid out by :func:`_slabs`,
    and the stages follow one another: every weight appears once."""
    key = ("w8a8", str(device))
    if key not in _SLAB_INDEX:
        offs = [0]
        for j, cin in enumerate(_W8_CIN):
            offs.append(offs[-1] + 9 * cin * _w8_cols(j))
        _SLAB_INDEX[key] = torch.cat([
            _slabs(torch.cat([_s8_steps(j, s, _w8_cols(j), offs[j])
                              for j in range(s)]))
            for s in range(1, 6)]).to(device)
    return _SLAB_INDEX[key]


class W8A8Weights(NamedTuple):
    """One quantized block's operands of ``rdb_w8a8_kernel``, or a stack
    of them on leading axes (:meth:`block` takes one)."""

    wq: torch.Tensor     # int8 B slabs (:func:`slab_index_w8a8`)
    deq: torch.Tensor    # float32 (640,): x's 192, x1's 160, .. x4's 64
    qm: torch.Tensor     # float32 (5,): x's, then x1..x4's
    b: torch.Tensor      # float32 (192,): conv1..conv5's biases

    def block(self, i) -> "W8A8Weights":
        return W8A8Weights(*(t[i] for t in self))


def pack_rdb_w8a8(qp: dict) -> W8A8Weights:
    """One RDB of ``rrdbnet_int8.quantize_body`` (``w8``, ``deq``, ``qm``,
    ``b``), or a stack of them on leading axes (a quantized body's
    ``rdbJ``), as the full-W8A8 kernel's operands on the same device:
    the slab gather runs once here, not per launch."""
    w8 = qp["w8"]
    lead = tuple(w8[0].shape[:-4])
    for j, w in enumerate(w8):
        want = (*lead, 3, 3, _W8_CIN[j], _w8_cols(j))
        if tuple(w.shape) != want or w.dtype != torch.int8:
            raise ValueError(f"w8[{j}] must be int8 {want}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    flat = torch.cat([w.reshape(*lead, -1) for w in w8], -1)
    return W8A8Weights(
        _gather(flat, slab_index_w8a8),
        torch.cat([d.float() for d in qp["deq"]], -1).contiguous(),
        qp["qm"].float().contiguous(),
        torch.cat([t.float() for t in qp["b"]], -1).contiguous())


def kernel_tiling_w8a8() -> dict:
    """:func:`kernel_tiling` of ``rdb_w8a8_kernel``: the bf16 kernel's
    tile; its shared memory (the B ring, x and x1..x4 in int8) and the
    multiply-adds of its 64-row M tiles (``rdb_i8_kernel``'s)."""
    lib = _lib()
    return {**kernel_tiling(torch.bfloat16),
            "smem_bytes": int(lib.s2sr_rdb_w8a8_smem_bytes()),
            "macs_per_tile": int(lib.s2sr_rdb_i8_macs_per_tile())}


def rdb_w8a8(x: torch.Tensor, qp: dict | None,
             mask: torch.Tensor | None = None,
             packed: W8A8Weights | None = None) -> torch.Tensor:
    """One residual dense block in full W8A8, (B, H, W, 64) → same, in
    ``x.dtype``.

    ``qp``: one RDB of ``rrdbnet_int8.quantize_body``; ``packed``: its
    :func:`pack_rdb_w8a8` on ``x``'s device, packed once by the caller;
    ``mask``: None or float32 0/1 of shape (B, H, W) or (B, H, W, 1). CPU
    tensors run :func:`rdb_w8a8_reference` on ``qp``; CUDA tensors launch
    ``rdb_w8a8_kernel`` on ``packed`` or raise (it takes bfloat16
    only)."""
    global LAUNCHES_W8A8
    if x.device.type == "cpu":
        return rdb_w8a8_reference(x, qp, mask)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_w8a8: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rdb_w8a8's kernel takes bfloat16, got {x.dtype}")
    _check_x(x, mask)
    if packed is None:
        raise ValueError("rdb_w8a8 on the card takes its operands packed: "
                         "pass packed=pack_rdb_w8a8(qp)")
    n_wq = slab_index_w8a8().numel()
    for name, t, dt, n in (("wq", packed.wq, torch.int8, n_wq),
                           ("deq", packed.deq, torch.float32, 640),
                           ("qm", packed.qm, torch.float32, 5),
                           ("b", packed.b, torch.float32, sum(_COUT))):
        if (t.device != x.device or t.dtype != dt or t.dim() != 1
                or t.numel() != n or not t.is_contiguous()):
            raise ValueError(f"rdb_w8a8 packed {name} must be a contiguous "
                             f"{dt} vector of {n} on {x.device}")
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_w8a8_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), packed.wq.data_ptr(), packed.deq.data_ptr(),
            packed.qm.data_ptr(), packed.b.data_ptr(), bsz, h, wd, stream)
    if rc != 0:
        raise RuntimeError(f"rdb_w8a8 kernel launch failed: CUDA error {rc}")
    LAUNCHES_W8A8 += 1
    return out
