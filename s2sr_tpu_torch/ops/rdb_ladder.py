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
all nine taps (one (pixels, 9·Cin)×(9·Cin, N) product per conv). On the
tensor cores ``v2`` stages the ``dx`` taps once per band of positions and
reads its three ``dy`` parts from that band, row-shifted.

- :func:`rdb_v1` / :func:`rdb_v2` / :func:`rdb_v3` are the wrappers. On
  a CUDA tensor they launch a kernel or raise: bfloat16 rungs the
  tensor-core kernels of ``csrc/rdb_ladder_tc.cu`` (``wgmma``; they take
  the bf16 B images of :func:`pack_tc_images`), float32 the CUDA-core
  kernels of ``csrc/rdb_ladder.cu``. On a CPU tensor they run the rung's
  plain version (:data:`REFERENCES`).
- :data:`LAUNCHES` counts kernel launches per rung, nothing else.
- :func:`rdb_ladder_cuda_cores` launches the CUDA-core kernel of any rung
  and dtype, bf16 included: the kernels the tensor-core ones replaced,
  kept to compare with them on the card. It counts nothing.
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

from .matmul_chain import pack_wgmma
from .rdb import NF, G, check_kernel_shapes, unpack_rdb_weights

RUNGS = ("v1", "v2", "v3")
LAUNCHES = {rung: 0 for rung in RUNGS}
# the rungs whose bfloat16 instance runs on the tensor cores
TC_RUNGS = ("v1", "v2", "v3")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_RUNG_CODE = {"v1": 1, "v2": 2, "v3": 3}
_QUERY = {"tile": 0, "chunk": 1, "smem_bytes": 2, "macs_per_tile": 3}
_TC_QUERY = {"tile": 0, "pass_pixels": 1, "smem_bytes": 2,
             "macs_per_tile": 3, "blocks_per_sm": 4}
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


def tc_matrices(packed, rung: str) -> tuple:
    """The five (K, N) matrices the tensor-core kernel of ``rung`` runs,
    from its packed float32 weights, rows in the kernel's K order. v3: the
    packed ``(9·Cin, N)`` as they are, rows (tap, cin). v2: ``wx (3, 192,
    192)`` flattened, which is v3's ``(576, 192)``; each ``w_j (3, 96, N)``
    with every ``dy``'s 96 rows (dx, cin) padded to 128, ``(384, N)``, so
    that a K slab of 64 holds ``[dx 0 | dx 1]`` or ``[dx 2 | zero]`` of
    one ``dy``. v1: ``wx`` without x's 64 zero pad lanes, ``(576, 192)``
    rows (tap, channel), and each ``wg_k`` as ``(1152, N)`` rows (tap,
    lane), the zero rows of x_k..x4 kept."""
    blocks, _, _ = packed
    if rung == "v3":
        return tuple(blocks)
    if rung == "v2":
        wx, *ws = blocks
        return (wx.reshape(9 * NF, -1),
                *(F.pad(w, (0, 0, 0, 128 - w.shape[1])).reshape(384, -1)
                  for w in ws))
    if rung != "v1":
        raise ValueError(f"no tensor-core kernel for rung {rung}")
    wx, *wg = blocks
    x_rows = wx.reshape(9, LANES, wx.shape[-1])[:, :NF].reshape(9 * NF, -1)
    return (x_rows, *(w.reshape(9 * LANES, w.shape[-1]) for w in wg))


def pack_tc_images(packed, rung: str) -> tuple:
    """The bf16 B images of the tensor-core kernel of ``rung`` (one of
    :data:`TC_RUNGS`), from the rung's packed weights: each matrix of
    :func:`tc_matrices` as ``matmul_chain.pack_wgmma`` lays it out, K
    zero-padded to a multiple of 64, ``[K/64][N][64]`` with the 128-byte
    swizzle. Pack once per set of weights, outside a timed loop; the
    weights already hold bf16 values, so the images are exact."""
    return tuple(pack_wgmma(m.to(torch.bfloat16)) for m in tc_matrices(packed,
                                                                       rung))


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


def _tc_lib():
    from ._build import load

    lib = load("rdb_ladder_tc")
    if not getattr(lib, "_s2sr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.s2sr_rdb_ladder_tc_forward.argtypes = [ci, vp, vp, vp, vp, vp, vp,
                                                   vp, vp, vp, ci, ci, ci, vp]
        lib.s2sr_rdb_ladder_tc_forward.restype = ci
        lib.s2sr_rdb_ladder_tc_query.argtypes = [ci, ci]
        lib.s2sr_rdb_ladder_tc_query.restype = ctypes.c_longlong
        lib._s2sr_typed = True
    return lib


def _on_tensor_cores(rung: str, dtype: torch.dtype) -> bool:
    return rung in TC_RUNGS and dtype == torch.bfloat16


def kernel_tiling(rung: str, dtype: torch.dtype,
                  cuda_cores: bool = False) -> dict:
    """The tiling of the kernel the wrapper launches for ``rung`` and
    ``dtype`` (``cuda_cores``: of the CUDA-core kernel whatever the dtype),
    as the kernel source computes it: output tile side, dynamic
    shared-memory bytes per block, multiply-adds executed per output tile
    (halo recompute, padding and v1's zero rows included) and the route;
    the CUDA-core kernels give pixels per staged chunk, the tensor-core
    ones region pixels per pass and blocks per SM."""
    if _on_tensor_cores(rung, dtype) and not cuda_cores:
        lib = _tc_lib()
        out = {key: int(lib.s2sr_rdb_ladder_tc_query(_RUNG_CODE[rung], what))
               for key, what in _TC_QUERY.items()}
        return {**out, "route": "wgmma"}
    lib = _lib()
    out = {key: int(lib.s2sr_rdb_ladder_query(_RUNG_CODE[rung],
                                               _DTYPE_CODE[dtype], what))
           for key, what in _QUERY.items()}
    return {**out, "route": "cuda_cores"}


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


def tc_image_shapes(rung: str) -> list:
    """Shapes of :func:`pack_tc_images`' five images: ``(K/64, N, 8, 8)``
    (16-byte chunks of 8 values), K padded to a multiple of 64."""
    k_src = {"v1": 9 * LANES, "v2": 3 * 128, "v3": 9 * G}[rung]   # x_j's K
    ks = (9 * NF, *(k_src,) * 4)
    return [(-(-k // 64), n, 8, 8) for k, (_, n) in
            zip(ks, (s[-2:] for s in _SHAPES[rung]))]


def _check_images(x, images, rung):
    want = tc_image_shapes(rung)
    if len(images) != len(want):
        raise ValueError(f"rdb_{rung} wants {len(want)} B images, got "
                         f"{len(images)}")
    for j, (t, shape) in enumerate(zip(images, want)):
        if (t.device != x.device or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"rdb_{rung} image {j} must be a contiguous, "
                             f"16-byte aligned bfloat16 {shape} tensor on "
                             f"{x.device}")


def _run_kernel(x, packed, rung, images):
    """One launch on the card: the tensor-core kernel when ``images`` is
    given, else the CUDA-core kernel. Returns the output."""
    _check(x, packed, rung)
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if bsz * h * wd == 0:
        return out
    blocks, b14, b5 = packed
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if images is not None:
            _check_images(x, images, rung)
            rc = _tc_lib().s2sr_rdb_ladder_tc_forward(
                _RUNG_CODE[rung], x.data_ptr(), out.data_ptr(),
                *(t.data_ptr() for t in images), b14.data_ptr(),
                b5.data_ptr(), bsz, h, wd, stream)
        else:
            rc = _lib().s2sr_rdb_ladder_forward(
                _RUNG_CODE[rung], x.data_ptr(), out.data_ptr(),
                *(t.data_ptr() for t in blocks), b14.data_ptr(),
                b5.data_ptr(), bsz, h, wd, _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rdb_{rung} kernel launch failed: CUDA error {rc}")
    return out


def _launch(x: torch.Tensor, packed, rung: str, images=None) -> torch.Tensor:
    if x.device.type == "cpu":
        return REFERENCES[rung](x, packed)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_{rung}: unsupported device {x.device}")
    if not _on_tensor_cores(rung, x.dtype):
        images = None
    elif images is None:
        raise ValueError(f"rdb_{rung} in bfloat16 on the card runs the "
                         "tensor-core kernel: pass images=pack_tc_images("
                         f"packed, {rung!r}), packed once")
    out = _run_kernel(x, packed, rung, images)
    LAUNCHES[rung] += 1
    return out


def rdb_ladder_cuda_cores(x: torch.Tensor, packed, rung: str) -> torch.Tensor:
    """One RDB through the CUDA-core kernel of ``rung`` in
    ``csrc/rdb_ladder.cu``, for a CUDA tensor of either dtype: for bf16
    the kernel the tensor-core one replaced, kept to compare the two on
    the card. Not a path of the port; counts nothing."""
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_ladder_cuda_cores wants a CUDA tensor, "
                           f"got {x.device}")
    return _run_kernel(x, packed, rung, None)


def rdb_v1(x: torch.Tensor, packed, images=None) -> torch.Tensor:
    """One RDB through the v1 rung, (B, H, W, 64) → same, in ``x.dtype``.
    ``packed``: :func:`pack_rdb_weights_v1` output on ``x``'s device;
    ``images``: ``pack_tc_images(packed, "v1")``, which a bf16 CUDA tensor
    needs (the tensor-core kernel) and other calls ignore. CPU tensors run
    :func:`rdb_v1_reference`; CUDA tensors launch the kernel or raise."""
    return _launch(x, packed, "v1", images)


def rdb_v2(x: torch.Tensor, packed, images=None) -> torch.Tensor:
    """One RDB through the v2 rung; as :func:`rdb_v1` with
    :func:`pack_rdb_weights_v2` weights and ``pack_tc_images(packed,
    "v2")``."""
    return _launch(x, packed, "v2", images)


def rdb_v3(x: torch.Tensor, packed, images=None) -> torch.Tensor:
    """One RDB through the v3 rung; as :func:`rdb_v1` with
    :func:`pack_rdb_weights_v3` weights and ``pack_tc_images(packed,
    "v3")``."""
    return _launch(x, packed, "v3", images)


WRAPPERS = {"v1": rdb_v1, "v2": rdb_v2, "v3": rdb_v3}
