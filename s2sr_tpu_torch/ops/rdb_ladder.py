"""The rungs of the RDB ablation ladder: hand-written Hopper kernels,
their weight packers and their plain PyTorch versions.

Replaces ``s2sr_tpu/ops/pallas/fused_rdb.py::rdb_pallas`` (rung ``v1``),
``::rdb_pallas_v2`` (rung ``v2``) and ``::rdb_pallas_v3`` (rung ``v3``).
All compute the function of ``s2sr_tpu/models/rrdbnet.py::_rdb_packed``.

``v1`` is the *K-packed concat form*: the conv of x emits
``[p1|p2|p3|p4|p5]`` (p1..p4 rounded to the storage dtype, p5 kept in
float32); x1..x4 are stacked in the 128 lanes of one growth buffer, and
stage k convolves all 128 lanes against weights whose rows for x_k..x4
are zero::

    x1 = lrelu(p1 + b1);   x_k = lrelu(p_k + conv(g, wg_k) + b_k)   k = 2..4
    out = 0.2·((p5 + conv(g, wg5)) + b5) + x

``v2`` and ``v3`` are the *delta form*: the conv of each source (x, then
x1..x4) emits its contributions to every later stage at once, into
accumulator slots c1..c5 kept in the storage dtype::

    [c5|c4|c3|c2|c1]  = conv(x,  wx)         N = 192
    x1 = lrelu(c1 + b1);  [c5|c4|c3|c2] += conv(x1, w1)   N = 160
    x2 = lrelu(c2 + b2);  [c5|c4|c3]    += conv(x2, w2)   N = 128
    x3 = lrelu(c3 + b3);  [c5|c4]       += conv(x3, w3)   N = 96
    x4 = lrelu(c4 + b4);  x5 = c5       +  conv(x4, w4)   N = 64
    out = 0.2·(x5 + b5) + x

``v1`` and ``v2`` stage the three ``dx`` taps of one ``dy`` side by
side (three (pixels, 3·Cin)×(3·Cin, N) products per conv), ``v3`` stages
all nine taps (one (pixels, 9·Cin)×(9·Cin, N) product per conv).

- :func:`rdb_v1` / :func:`rdb_v2` / :func:`rdb_v3` are the wrappers. On
  a CUDA tensor they launch the kernel in ``csrc/rdb_ladder.cu`` or
  raise; on a CPU tensor they run the rung's plain version
  (:data:`REFERENCES`).
- :data:`LAUNCHES` counts kernel launches per rung, nothing else.
- Weights travel as the TPU rungs pack them (``pack_rdb_weights_v1`` /
  ``_v2`` / ``_v3``): ``((w0, w1, w2, w3, w4), b14, b5)``, all float32
  tensors; the five matrices hold values rounded to the compute dtype
  (as ``ops/rdb.py`` stores its own), the biases stay float32 as given,
  since the rungs add them in float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .rdb import NF, G, check_kernel_shapes, unpack_rdb_weights

RUNGS = ("v1", "v2", "v3")
LAUNCHES = {rung: 0 for rung in RUNGS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_RUNG_CODE = {"v1": 1, "v2": 2, "v3": 3}
_QUERY = {"tile": 0, "chunk": 1, "smem_bytes": 2, "macs_per_tile": 3}
LANES = 4 * G                     # v1's growth buffer: x1..x4 stacked
# source j (0 = x, 1..4 = x_j): input channels and product width
_SRC_CIN = (NF, G, G, G, G)
_SRC_N = tuple(NF + G * (4 - j) for j in range(5))     # 192, 160, ..., 64
# the packed shapes each wrapper takes: (w0..w4, b14, b5)
_SHAPES = {
    "v1": [(3, 3 * LANES, n) for n in (NF + 4 * G, G, G, G, NF)],
    "v2": [(3, 3 * c, n) for c, n in zip(_SRC_CIN, _SRC_N)],
    "v3": [(9 * c, n) for c, n in zip(_SRC_CIN, _SRC_N)],
}


def _delta_blocks(kernels):
    """OIHW conv kernels → the five delta-form HWIO blocks, N-order
    ``[p5|p4|p3|p2|p1]`` for x down to ``[t5]`` for x4."""
    def sl(k, lo, hi):
        return kernels[k - 1][:, lo:hi].permute(2, 3, 1, 0)   # (3, 3, cin, cout)

    def pack(lo, hi, ks):
        return torch.cat([sl(k, lo, hi) for k in ks], dim=-1)

    return (pack(0, NF, (5, 4, 3, 2, 1)),
            pack(NF, NF + G, (5, 4, 3, 2)),
            pack(NF + G, NF + 2 * G, (5, 4, 3)),
            pack(NF + 2 * G, NF + 3 * G, (5, 4)),
            sl(5, NF + 3 * G, NF + 4 * G))


def _biases(biases):
    b14 = torch.cat([b.detach().float().reshape(-1) for b in biases[:4]])[None]
    b5 = biases[4].detach().float().reshape(1, -1)
    return b14.contiguous(), b5.contiguous()


def _pack(kernels, biases, dtype, rows):
    check_kernel_shapes(kernels)
    blocks = tuple(rows(w.to(dtype).float()).contiguous()
                   for w in _delta_blocks([k.detach() for k in kernels]))
    return (blocks, *_biases(biases))


def pack_rdb_weights_v1(kernels, biases, dtype: torch.dtype):
    """Five OIHW conv kernels + biases → the v1 rung's packed weights:
    ``wx (3, 384, 192)`` = ``[K1|K2|K3|K4|K5]`` over x's 64 channels and
    64 zero rows (x is carried at 128 lanes), ``wg2``..``wg4``
    ``(3, 384, 32)`` and ``wg5 (3, 384, 64)`` holding the rows of
    x1..x_{k-1} and zero rows above, rows ordered (dy; dx, lane);
    ``b14 (1, 128)``, ``b5 (1, 64)``. Port of
    ``fused_rdb.py::pack_rdb_weights``."""
    check_kernel_shapes(kernels)
    hwio = [k.detach().to(dtype).float().permute(2, 3, 1, 0) for k in kernels]

    def rows(w):                       # (3, 3, c, n) → (3, 3·128, n)
        w = F.pad(w, (0, 0, 0, LANES - w.shape[2]))
        return w.reshape(3, 3 * LANES, w.shape[3]).contiguous()

    blocks = (rows(torch.cat([w[:, :, :NF] for w in hwio], -1)),
              *(rows(w[:, :, NF:]) for w in hwio[1:]))
    return (blocks, *_biases(biases))


def pack_rdb_weights_v2(kernels, biases, dtype: torch.dtype):
    """Five OIHW conv kernels + biases → the v2 rung's packed weights:
    ``wx (3, 192, 192)``, ``w1 (3, 96, 160)``, ``w2 (3, 96, 128)``,
    ``w3 (3, 96, 96)``, ``w4 (3, 96, 64)``, rows ordered (dy; dx, cin);
    ``b14 (1, 128)``, ``b5 (1, 64)``. Port of
    ``fused_rdb.py::pack_rdb_weights_v2``."""
    return _pack(kernels, biases, dtype,
                 lambda w: w.reshape(3, 3 * w.shape[2], w.shape[3]))


def pack_rdb_weights_v3(kernels, biases, dtype: torch.dtype):
    """Like :func:`pack_rdb_weights_v2`, with the kernels flattened to
    ``(9·Cin, N)``, rows ordered (dy, dx, cin). Port of
    ``fused_rdb.py::pack_rdb_weights_v3``."""
    return _pack(kernels, biases, dtype,
                 lambda w: w.reshape(9 * w.shape[2], w.shape[3]))


PACKERS = {"v1": pack_rdb_weights_v1, "v2": pack_rdb_weights_v2,
           "v3": pack_rdb_weights_v3}


def pack_ladder_weights(w: torch.Tensor, b: torch.Tensor, rung: str,
                        dtype: torch.dtype):
    """The rung's packed weights from the flat ``(w, b)`` of
    ``ops/rdb.py::pack_rdb_weights``."""
    kernels, biases = unpack_rdb_weights(w, b)
    return PACKERS[rung](kernels, biases, dtype)


# --- plain versions --------------------------------------------------------

def _staged3(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv as the v1 and v2 rungs stage it: per ``dy`` the three
    ``dx`` taps side by side, three float32 products summed in float32."""
    _, h, wd, _ = v.shape
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        rows = vp[:, dy:dy + h]
        staged = torch.cat([rows[:, :, dx:dx + wd] for dx in range(3)], -1)
        part = staged.float() @ w[dy]
        acc = part if acc is None else acc + part
    return acc


def _conv_v2(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`_staged3`, output rounded to ``v.dtype``."""
    return _staged3(v, w).to(v.dtype)


def _conv_v3(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv as the v3 rung stages it: a 9-tap im2col, one
    float32 product, output rounded to ``v.dtype``."""
    _, h, wd, _ = v.shape
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    staged = torch.cat([vp[:, dy:dy + h, dx:dx + wd]
                        for dy in range(3) for dx in range(3)], -1)
    return (staged.float() @ w).to(v.dtype)


def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v * 0.2)


def _delta_rdb(x: torch.Tensor, packed, conv) -> torch.Tensor:
    """The delta-form RDB, rounding where the TPU rungs round: every
    product's output and every slot add in ``x.dtype``; bias, LeakyReLU
    and the tail ``0.2·(x5 + b5) + x`` in float32."""
    (wx, w1, w2, w3, w4), b14, b5 = packed
    dtype = x.dtype
    b14 = b14.reshape(-1).float()
    b5 = b5.reshape(-1).float()

    def act(c, k):
        return _lrelu(c.float() + b14[(k - 1) * G:k * G]).to(dtype)

    c5, c4, c3, c2, c1 = torch.split(conv(x, wx), [NF, G, G, G, G], -1)
    q5, q4, q3, q2 = torch.split(conv(act(c1, 1), w1), [NF, G, G, G], -1)
    c5, c4, c3, c2 = c5 + q5, c4 + q4, c3 + q3, c2 + q2
    r5, r4, r3 = torch.split(conv(act(c2, 2), w2), [NF, G, G], -1)
    c5, c4, c3 = c5 + r5, c4 + r4, c3 + r3
    s5, s4 = torch.split(conv(act(c3, 3), w3), [NF, G], -1)
    c5, c4 = c5 + s5, c4 + s4
    x5 = c5 + conv(act(c4, 4), w4)
    return ((x5.float() + b5) * 0.2 + x.float()).to(dtype)


def rdb_v1_reference(x: torch.Tensor, packed) -> torch.Tensor:
    """Plain PyTorch version of the v1 rung: (B, H, W, 64) → same. Rounds
    where the TPU rung stores: p1..p4 and each x_k to ``x.dtype``; p5, the
    growth convs, bias, LeakyReLU and the tail stay float32."""
    (wx, *wg), b14, b5 = packed
    dtype = x.dtype
    b14 = b14.reshape(-1).float()
    p = _staged3(F.pad(x, (0, LANES - NF)), wx)         # [p1|p2|p3|p4|p5]
    pk = p[..., :LANES].to(dtype).float()
    xs = []
    for k in range(1, 5):
        v = pk[..., (k - 1) * G:k * G]
        if k > 1:                      # x_k..x4 are zero in the buffer
            g = torch.cat(xs + [torch.zeros_like(xs[0])] * (5 - k), -1)
            v = v + _staged3(g, wg[k - 2])
        xs.append(_lrelu(v + b14[(k - 1) * G:k * G]).to(dtype))
    x5 = (p[..., LANES:] + _staged3(torch.cat(xs, -1), wg[3])
          + b5.reshape(-1).float())
    return (x5 * 0.2 + x.float()).to(dtype)


def rdb_v2_reference(x: torch.Tensor, packed) -> torch.Tensor:
    """Plain PyTorch version of the v2 rung: (B, H, W, 64) → same."""
    return _delta_rdb(x, packed, _conv_v2)


def rdb_v3_reference(x: torch.Tensor, packed) -> torch.Tensor:
    """Plain PyTorch version of the v3 rung: (B, H, W, 64) → same."""
    return _delta_rdb(x, packed, _conv_v3)


REFERENCES = {"v1": rdb_v1_reference, "v2": rdb_v2_reference,
              "v3": rdb_v3_reference}


# --- the kernels -------------------------------------------------------------

def _lib():
    from ._build import load

    lib = load("rdb_ladder")
    if not getattr(lib, "_s2sr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.s2sr_rdb_ladder_forward.argtypes = [ci, vp, vp, vp, vp, vp, vp,
                                                vp, vp, vp, ci, ci, ci, ci,
                                                vp]
        lib.s2sr_rdb_ladder_forward.restype = ci
        lib.s2sr_rdb_ladder_query.argtypes = [ci, ci, ci]
        lib.s2sr_rdb_ladder_query.restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def kernel_tiling(rung: str, dtype: torch.dtype) -> dict:
    """The rung's output tile side, pixels per staged chunk, dynamic
    shared-memory bytes per block and multiply-adds executed per output
    tile (halo recompute, chunk padding and v1's zero rows included), as
    the kernel source computes them."""
    lib = _lib()
    return {key: int(lib.s2sr_rdb_ladder_query(_RUNG_CODE[rung],
                                                _DTYPE_CODE[dtype], what))
            for key, what in _QUERY.items()}


def _check(x, packed, rung):
    if x.dim() != 4 or x.shape[-1] != NF:
        raise ValueError(f"rdb_{rung} wants (B, H, W, {NF}), "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rdb_{rung} supports float32/bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"rdb_{rung} wants a contiguous, 16-byte aligned "
                         "NHWC tensor")
    blocks, b14, b5 = packed
    want = _SHAPES[rung] + [(1, 4 * G), (1, NF)]
    for name, t, shape in zip(("w0", "w1", "w2", "w3", "w4", "b14", "b5"),
                              (*blocks, b14, b5), want):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"rdb_{rung} packed {name} must be a contiguous, "
                             f"16-byte aligned float32 {shape} tensor on "
                             f"{x.device}")


def _launch(x: torch.Tensor, packed, rung: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return REFERENCES[rung](x, packed)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_{rung}: unsupported device {x.device}")
    _check(x, packed, rung)
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    blocks, b14, b5 = packed
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.s2sr_rdb_ladder_forward(
            _RUNG_CODE[rung], x.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in blocks), b14.data_ptr(), b5.data_ptr(),
            bsz, h, wd, _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rdb_{rung} kernel launch failed: CUDA error {rc}")
    LAUNCHES[rung] += 1
    return out


def rdb_v1(x: torch.Tensor, packed) -> torch.Tensor:
    """One RDB through the v1 rung, (B, H, W, 64) → same, in ``x.dtype``.
    ``packed``: :func:`pack_rdb_weights_v1` output on ``x``'s device.
    CPU tensors run :func:`rdb_v1_reference`; CUDA tensors launch the
    kernel or raise."""
    return _launch(x, packed, "v1")


def rdb_v2(x: torch.Tensor, packed) -> torch.Tensor:
    """One RDB through the v2 rung; as :func:`rdb_v1` with
    :func:`pack_rdb_weights_v2` weights."""
    return _launch(x, packed, "v2")


def rdb_v3(x: torch.Tensor, packed) -> torch.Tensor:
    """One RDB through the v3 rung; as :func:`rdb_v1` with
    :func:`pack_rdb_weights_v3` weights."""
    return _launch(x, packed, "v3")


WRAPPERS = {"v1": rdb_v1, "v2": rdb_v2, "v3": rdb_v3}
