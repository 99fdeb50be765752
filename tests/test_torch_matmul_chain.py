"""Port's matrix-unit microbenchmark (``s2sr_tpu_torch.ops.matmul_chain``,
``s2sr_tpu_torch.bench.mxu`` and ``bench.peak``) against the JAX
package's Pallas kernels ``_pallas_chain`` and ``_pair_chain`` of
``scripts/bench_mxu.py``, run in interpret mode.

The script's kernels take no ``interpret`` flag and read the module
globals ``M``/``MT`` when traced, so the test loads the script as a
module of its own and patches that module only: ``pl.pallas_call``
becomes ``pallas_call(..., interpret=True)`` and ``M, MT = 96, 48``.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those versions on the card by ``chip_smoke.py``
(phase mxu). :func:`emulate_product` replays the kernel's fragment
indexing (``ldmatrix`` addresses, the packed B fragments, the
accumulator layout) in numpy, so the layout the kernel relies on is
checked here too.
"""

import functools
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from s2sr_tpu_torch.bench import mxu as bench
from s2sr_tpu_torch.bench import peak as peak_bench
from s2sr_tpu_torch.ops import matmul_chain as mc
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
M, MT = 96, 48


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "bench_mxu_under_test", ROOT / "scripts" / "bench_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_mxu(script, monkeypatch):
    """The script's module with its Pallas calls in interpret mode at
    M, MT = 96, 48."""
    monkeypatch.setattr(script, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    monkeypatch.setattr(script, "M", M)
    monkeypatch.setattr(script, "MT", MT)
    return script


def zero_mean(shape, fan_in, seed):
    """N(0, 1) / sqrt(fan_in), rounded to bf16, as float32 numpy: a chain
    of such products stays O(1) and does not collapse onto one vector,
    so a wrong step shows."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape) / np.sqrt(fan_in)
    return torch.from_numpy(v.astype(np.float32)).bfloat16().float().numpy()


def compare(got: torch.Tensor, want: np.ndarray) -> dict:
    """Bit-equal, or the share of elements that differ and the largest
    difference in bf16 ulps of the largest output."""
    g = got.float().numpy()
    diff = np.abs(g - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return {"equal": bool((diff == 0).all()), "share": float((diff > 0).mean()),
            "ulps": float(diff.max() / ulp)}


# Both round each float32 product to bf16, but not bit for bit: at one
# step the JAX kernel equals the exactly rounded product, while torch's
# float32 CPU product sums in another order and lands 1 ulp off on
# 0.005–0.02% of the elements. Each step mixes a row's errors into all of
# its columns, so after 3 steps 0.26–0.61% of the elements differ, all
# within 0.5 bf16 ulp of the largest output (measured on these inputs).
# Allowed: 1 bf16 ulp of the largest output, on at most 0.1% of the
# elements after one step (products) and 1% after three (chains).
SHARE = {1: 1e-3, 3: 1e-2}


def assert_tracks(got, want, steps):
    r = compare(got, want)
    assert r["equal"] or (r["ulps"] <= 1 and r["share"] <= SHARE[steps]), r


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("repeat", [1, 3])
@pytest.mark.parametrize("k", [64, 96, 192, 512])
def test_chain_matches_jax_pallas(jax_mxu, k, repeat, stage):
    x = zero_mean((M, k), 1, 1)
    w = zero_mean((k, k), k, 2)
    want = np.asarray(jax_mxu._pallas_chain(k, repeat, stage)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ).astype(jnp.float32))
    got = mc.matmul_chain(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(w).bfloat16(), repeat, stage)
    assert got.dtype == torch.bfloat16 and got.shape == (M, k)
    assert_tracks(got, want, repeat)


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("k,n", [(64, 32), (96, 128)])
def test_pair_matches_jax_pallas(jax_mxu, k, n, stage):
    x = zero_mean((M, k), 1, 3)
    w1 = zero_mean((k, n), k, 4)
    w2 = zero_mean((n, k), n, 5)
    want = np.asarray(jax_mxu._pair_chain(k, n, 3, stage)(
        *(jnp.asarray(v, jnp.bfloat16) for v in (x, w1, w2))
    ).astype(jnp.float32))
    got = mc.pair_chain(*(torch.from_numpy(v).bfloat16() for v in (x, w1, w2)),
                        3, stage)
    assert got.shape == (M, k)
    assert_tracks(got, want, 3)


# The ring's pair, 384×192, at one step (two products): after three, 1%
# of the elements sit 1 bf16 ulp off JAX's even for the exactly rounded
# (float64) chain (1.03% measured on these inputs), as JAX's float32 sums
# at K 384 round otherwise; one step keeps SHARE[1].
@pytest.mark.parametrize("stage", [False, True])
def test_ring_pair_matches_jax_pallas(jax_mxu, stage):
    k, n = mc.RING_SHAPES["pair_chain"]
    x = zero_mean((M, k), 1, 3)
    w1 = zero_mean((k, n), k, 4)
    w2 = zero_mean((n, k), n, 5)
    want = np.asarray(jax_mxu._pair_chain(k, n, 1, stage)(
        *(jnp.asarray(v, jnp.bfloat16) for v in (x, w1, w2))
    ).astype(jnp.float32))
    got = mc.pair_chain(*(torch.from_numpy(v).bfloat16() for v in (x, w1, w2)),
                        1, stage)
    assert got.shape == (M, k)
    assert_tracks(got, want, 1)


def test_chain_is_not_trivial():
    """The zero-mean chain stays away from zero and from a step fewer, so
    the comparisons above can see a wrong step."""
    x = torch.from_numpy(zero_mean((M, 96), 1, 1)).bfloat16()
    w = torch.from_numpy(zero_mean((96, 96), 96, 2)).bfloat16()
    out = mc.matmul_chain_reference(x, w, 8).float()
    fewer = mc.matmul_chain_reference(x, w, 7).float()
    assert 0.3 < out.abs().max() < 30
    assert (out - fewer).abs().max() > 0.5 * out.abs().max()


@pytest.mark.parametrize("name", mc.KERNELS)
def test_stage_changes_no_value(name):
    x = torch.from_numpy(zero_mean((40, 64), 1, 6)).bfloat16()
    ws = ((torch.from_numpy(zero_mean((64, 64), 64, 7)).bfloat16(),)
          if name == "matmul_chain" else
          (torch.from_numpy(zero_mean((64, 48), 64, 7)).bfloat16(),
           torch.from_numpy(zero_mean((48, 64), 48, 8)).bfloat16()))
    before = dict(mc.LAUNCHES)
    plain = mc.WRAPPERS[name](x, *ws, 4)
    staged = mc.WRAPPERS[name](x, *ws, 4, stage=True)
    assert torch.equal(plain, staged)
    assert torch.equal(plain, mc.REFERENCES[name](x, *ws, 4))
    assert mc.LAUNCHES == before == {"matmul_chain": 0, "pair_chain": 0}


@pytest.mark.parametrize("name", mc.KERNELS)
def test_library_equals_plain_on_cpu(name):
    x = torch.from_numpy(zero_mean((64, 96), 1, 9)).bfloat16()
    if name == "matmul_chain":
        ws = (torch.from_numpy(zero_mean((96, 96), 96, 10)).bfloat16(),)
        lib = mc.matmul_chain_library(x, *ws, 5)
    else:
        ws = (torch.from_numpy(zero_mean((96, 32), 96, 10)).bfloat16(),
              torch.from_numpy(zero_mean((32, 96), 32, 11)).bfloat16())
        lib = mc.pair_chain_library(x, *ws, 5)
    want = mc.REFERENCES[name](x, *ws, 5)
    assert lib.dtype == torch.bfloat16
    assert_tracks(lib, want.float().numpy(), 3)


def emulate_product(a: np.ndarray, packed: np.ndarray, kout: int) -> np.ndarray:
    """The kernel's ``product()`` for one warp, in float32 numpy: A
    fragments gathered as ``ldmatrix.x4`` returns them from the addresses
    the lanes give, B fragments read from the packed weights, each
    m16n8k16 done from the fragments in the PTX layout, and the
    accumulators written where the kernel writes them."""
    kin = a.shape[1]
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out = np.zeros((16, kout), np.float32)
    pk = packed.reshape(kin // 16, kout // 16, 32, 8)
    for kt in range(kin // 16):
        # ldmatrix: lane L addresses row L % 16, column 16kt + 8(L // 16);
        # matrix i is rows 8i..8i+7 of the addresses; lane l receives
        # row l // 4, elements 2(l % 4), 2(l % 4) + 1 of each matrix
        rows = lanes % 16
        cols = 16 * kt + 8 * (lanes // 16)
        frag = np.zeros((32, 4, 2), np.float32)
        for i in range(4):
            src = 8 * i + lanes // 4
            for e in range(2):
                frag[:, i, e] = a[rows[src], cols[src] + 2 * t + e]
        # the A tile as m16n8k16 reads a0..a3 from the lanes
        tile_a = np.zeros((16, 16), np.float32)
        for i, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            for e in range(2):
                tile_a[g + dr, 2 * t + e + dc] = frag[:, i, e]
        for nt in range(kout // 16):
            for j in range(2):
                tile_b = np.zeros((16, 8), np.float32)
                for h in range(2):
                    for p in range(2):
                        # b_h: rows 2t + p + 8h, column g
                        tile_b[2 * t + p + 8 * h, g] = pk[kt, nt, :, 4 * j + 2 * h + p]
                d = tile_a @ tile_b
                # c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8
                col = 16 * nt + 8 * j + 2 * t
                for e in range(2):
                    out[g, col + e] += d[g, 2 * t + e]
                    out[g + 8, col + e] += d[g + 8, 2 * t + e]
    return out


@pytest.mark.parametrize("kin,kout", [(16, 16), (64, 96), (96, 32)])
def test_fragment_emulation_matches_matmul(kin, kout):
    a = zero_mean((16, kin), 1, 12)
    w = zero_mean((kin, kout), kin, 13)
    packed = mc.pack_fragments(torch.from_numpy(w)).numpy()
    assert packed.shape == (kin // 16, kout // 16, 8, 4, 2, 2, 2)
    np.testing.assert_allclose(emulate_product(a, packed, kout), a @ w,
                               rtol=1e-5, atol=1e-5)


# the wgmma path's products in phase mxu of chip_smoke.py: (K_in, N_out)
WGMMA_PRODUCTS = [(k, k) for k in (64, 96, 128, 160, 192, 256)] + [
    pr for k, n in ((64, 128), (96, 128), (96, 160), (288, 128))
    for pr in ((k, n), (n, k))]


def wgmma_b_tile(image: np.ndarray, kin: int, nout: int, kk: int) -> np.ndarray:
    """The (16, N) B operand that the kernel's ``wgmma``s of k-slab ``kk``
    read from the shared-memory image: descriptor start ``(kk // 4)·N·128
    + (kk % 4)·32`` (+ ``p·NI·128`` for part ``p`` above 256 columns), then
    for element (k, n) the canonical K-major address ``start + (n // 8)·SBO
    + (n % 8)·128 + 2k`` with SBO 1024 bytes, and the 128-byte swizzle
    applied to the address: bits 4–6 XOR bits 7–9."""
    raw = image.reshape(-1)                       # bf16 elements
    parts = 2 if nout > 256 else 1
    ni = nout // parts
    tile = np.zeros((16, nout), raw.dtype)
    for p in range(parts):
        start = (kk // 4) * nout * 128 + (kk % 4) * 32 + p * ni * 128
        n = np.arange(ni)[None, :]
        k = np.arange(16)[:, None]
        addr = start + (n // 8) * 1024 + (n % 8) * 128 + 2 * k
        addr = addr ^ (((addr >> 7) & 7) << 4)
        tile[:, p * ni:(p + 1) * ni] = raw[addr // 2]
    return tile


@pytest.mark.parametrize("kin,nout", WGMMA_PRODUCTS)
def test_wgmma_image_unpacks_to_w(kin, nout):
    """Walking the descriptors over ``pack_wgmma``'s image gives back W,
    slab by slab, for every product of phase mxu."""
    w = zero_mean((kin, nout), kin, 21)
    image = mc.pack_wgmma(torch.from_numpy(w)).numpy()
    assert image.size == -(-kin // 64) * 64 * nout          # the C image_bytes / 2
    got = np.concatenate([wgmma_b_tile(image, kin, nout, kk)
                          for kk in range(kin // 16)])
    assert np.array_equal(got, w)


def test_wgmma_chain_step_emulation():
    """One chain step of a warpgroup as the kernel runs it, in numpy: A in
    wgmma's register layout (warp w rows 16w.., lane 4g + t: registers
    r = 0..3 at row g + 8(r & 1), columns 16s + 8(r >> 1) + 2t), B from
    the image through the descriptors, the f32 accumulator in its layout
    (n8 block j: d[4j], d[4j+1] at row g, columns 8j + 2t, +1; d[4j+2],
    d[4j+3] at row g + 8), then ``to_operand``'s pairing d[8s + 2r],
    d[8s + 2r + 1] → register r of slab s. Reassembled, the next A must
    be A @ W."""
    kin, nout = 96, 160
    a = zero_mean((64, kin), 1, 22)
    w = zero_mean((kin, nout), kin, 23)
    image = mc.pack_wgmma(torch.from_numpy(w)).numpy()
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4

    def regs_of(mat, width):               # [warp][lane][slab][reg][2]
        out = np.zeros((4, 32, width // 16, 4, 2), np.float32)
        for wp in range(4):
            for s_ in range(width // 16):
                for r in range(4):
                    row = 16 * wp + g + 8 * (r & 1)
                    col = 16 * s_ + 8 * (r >> 1) + 2 * t
                    out[wp, :, s_, r, 0] = mat[row, col]
                    out[wp, :, s_, r, 1] = mat[row, col + 1]
        return out

    areg = regs_of(a, kin)
    acc = np.zeros((4, 32, nout // 2), np.float32)
    for kk in range(kin // 16):
        # the A slab as the warpgroup holds it, then the product
        slab = np.zeros((64, 16), np.float32)
        for wp in range(4):
            for r in range(4):
                for e in range(2):
                    slab[16 * wp + g + 8 * (r & 1), 8 * (r >> 1) + 2 * t + e] = \
                        areg[wp, :, kk, r, e]
        d = slab @ wgmma_b_tile(image, kin, nout, kk)
        for wp in range(4):
            for j in range(nout // 8):
                for e in range(2):
                    acc[wp, :, 4 * j + e] += d[16 * wp + g, 8 * j + 2 * t + e]
                    acc[wp, :, 4 * j + 2 + e] += d[16 * wp + g + 8, 8 * j + 2 * t + e]
    nxt = np.zeros((64, nout), np.float32)
    for wp in range(4):
        for s_ in range(nout // 16):
            for r in range(4):
                row = 16 * wp + g + 8 * (r & 1)
                col = 16 * s_ + 8 * (r >> 1) + 2 * t
                nxt[row, col] = acc[wp, :, 8 * s_ + 2 * r]
                nxt[row, col + 1] = acc[wp, :, 8 * s_ + 2 * r + 1]
    np.testing.assert_allclose(nxt, a @ w, rtol=1e-5, atol=1e-5)


# --- the ring kernel (wg_ring_chain_kernel) -----------------------------------

LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def frag_at(s: int, q: int):
    """Rows (warp, lane) and first columns of register ``q`` of K slab
    ``s`` in wgmma's A layout (= its accumulator's pairing, to_operand):
    row 16w + g + 8(q & 1), columns 16s + 8(q >> 1) + 2t, +1."""
    rows = 16 * np.arange(4)[:, None] + G[None, :] + 8 * (q & 1)
    return rows, np.broadcast_to(16 * s + 8 * (q >> 1) + 2 * T, rows.shape)


def to_regs(mat: np.ndarray) -> np.ndarray:
    """(64, W) → registers ``[W/16][4][warp][lane][2]``."""
    regs = np.zeros((mat.shape[1] // 16, 4, 4, 32, 2), mat.dtype)
    for s_ in range(regs.shape[0]):
        for q in range(4):
            rows, cols = frag_at(s_, q)
            regs[s_, q, ..., 0] = mat[rows, cols]
            regs[s_, q, ..., 1] = mat[rows, cols + 1]
    return regs


def from_regs(regs: np.ndarray) -> np.ndarray:
    mat = np.zeros((64, 16 * regs.shape[0]), regs.dtype)
    for s_ in range(regs.shape[0]):
        for q in range(4):
            rows, cols = frag_at(s_, q)
            mat[rows, cols] = regs[s_, q, ..., 0]
            mat[rows, cols + 1] = regs[s_, q, ..., 1]
    return mat


def acc_to_regs(acc: np.ndarray) -> np.ndarray:
    """The m64nN float accumulator ``[warp][lane][N/2]`` paired as the
    kernel packs it: register q of slab s ← acc[8s + 2q], acc[8s + 2q + 1],
    rounded to bf16 (RN)."""
    ns = acc.shape[2] // 8
    regs = np.zeros((ns, 4, 4, 32, 2))
    for s_ in range(ns):
        for q in range(4):
            for e in range(2):
                regs[s_, q, ..., e] = acc[..., 8 * s_ + 2 * q + e]
    return bf16(regs)


def bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(v, np.float32)).bfloat16().double().numpy()


class Ring:
    """The slab stream as the consumers meet it: slab after slab of the
    packed image, in order, each read by its four descriptors."""

    def __init__(self, image: np.ndarray, cols: int):
        self.slabs = image.reshape(-1, cols * 64)
        self.cols, self.next = cols, 0

    def product(self, a_regs: np.ndarray) -> np.ndarray:
        """ring_product: acc = A @ B over A's K slabs, four a ring slab,
        each wgmma m64n(cols)k16 from A's registers into the float
        accumulator's layout (n8 tile j: acc[4j], acc[4j+1] at row g,
        columns 8j + 2t, +1; acc[4j+2], acc[4j+3] at row g + 8)."""
        acc = np.zeros((4, 32, self.cols // 2))
        for j in range(a_regs.shape[0] // 4):
            slab = self.slabs[self.next]
            self.next += 1
            for kk in range(4):
                d = from_regs(a_regs[4 * j + kk][None]) @ wgmma_b_tile(
                    slab, 64, self.cols, kk).astype(np.float64)
                for jt in range(self.cols // 8):
                    for e in range(2):
                        r0 = 16 * np.arange(4)[:, None] + G[None, :]
                        c = 8 * jt + 2 * T + e
                        acc[..., 4 * jt + e] += d[r0, c]
                        acc[..., 4 * jt + 2 + e] += d[r0 + 8, c]
        return acc


@pytest.mark.parametrize("kin,nout,cols", [(512, 512, 128), (384, 192, 192),
                                           (192, 384, 192)])
def test_wgmma_slabs_unpack_to_w(kin, nout, cols):
    """``pack_wgmma_slabs``'s stream, walked slab by slab by the ring
    kernel's four descriptors a slab, gives back W: slab i is K block
    i % (K/64) of column block i // (K/64)."""
    w = zero_mean((kin, nout), kin, 24)
    image = mc.pack_wgmma_slabs(torch.from_numpy(w), cols).numpy()
    slabs = image.reshape(-1, cols * 64)
    assert slabs.shape[0] == (nout // cols) * (kin // 64)
    got = np.zeros_like(w)
    for i, slab in enumerate(slabs):
        cb, kb = divmod(i, kin // 64)
        for kk in range(4):
            got[64 * kb + 16 * kk:64 * kb + 16 * kk + 16,
                cols * cb:cols * (cb + 1)] = wgmma_b_tile(slab, 64, cols, kk)
    assert np.array_equal(got, w)


def test_ring_chain_step_emulation():
    """One K-512 chain step of a warpgroup as wg_ring_chain_kernel runs it:
    A in registers, 4 chunks of 128 columns × 8 ring slabs; chunks 0–2
    packed into the warpgroup's stage tile at each thread's own places
    (row stride K − 128 + 8, 4-byte stores), chunk 3 straight into A's
    last 8 K slabs, then A's first 24 reloaded from the stage. The next A
    must be bf16(A @ W) bit for bit (sums in float64 here); every stage
    element is written once a step, and a warp's 32 stores of one register
    fall on 32 banks."""
    k = 512
    plan = mc.ring_smem_plan("matmul_chain")
    lds = plan["stage_bytes"] // (64 * 2)           # a warpgroup's tile
    assert lds == k - 128 + 8
    a = bf16(zero_mean((64, k), 1, 25))
    w = zero_mean((k, k), k, 26)
    ring = Ring(mc.pack_wgmma_slabs(torch.from_numpy(w), 128).numpy(), 128)
    regs = to_regs(a)
    stage = np.full(64 * lds, np.nan)
    writes = np.zeros(64 * lds, int)
    for c in range(k // 128):
        chunk = acc_to_regs(ring.product(regs))
        if c == k // 128 - 1:
            regs[k // 16 - 8:] = chunk
            continue
        for s_ in range(8):
            for q in range(4):
                rows, _ = frag_at(0, q)                   # 16w + g + 8(q & 1)
                at = rows * lds + 128 * c + 16 * s_ + 8 * (q >> 1) + 2 * T
                words = (at // 2) % 32
                assert all(len(set(words[wp])) == 32 for wp in range(4))
                for e in range(2):
                    stage[at + e] = chunk[s_, q, ..., e]
                    np.add.at(writes, at + e, 1)
    assert ring.next == plan["slabs_a_step"] == 32
    assert writes.max() == 1 and writes.reshape(64, lds)[:, :k - 128].min() == 1
    for s_ in range(k // 16 - 8):
        for q in range(4):
            rows, _ = frag_at(0, q)
            at = rows * lds + 16 * s_ + 8 * (q >> 1) + 2 * T
            for e in range(2):
                regs[s_, q, ..., e] = stage[at + e]
    assert np.array_equal(from_regs(regs), bf16(a @ w.astype(np.float64)))


def test_ring_pair_step_emulation():
    """One 384×192 pair step as wg_ring_chain_kernel runs it: x @ w1 over 6
    ring slabs of 192 columns, mid = bf16 in registers, then mid @ w2 a
    half of 192 columns at a time (3 slabs each), the first half's packed
    output held in x's first 12 K slabs while the second runs. The next x
    must be bf16(bf16(x @ w1) @ w2) bit for bit (sums in float64)."""
    k, n = mc.RING_SHAPES["pair_chain"]
    x = bf16(zero_mean((64, k), 1, 27))
    w1 = zero_mean((k, n), k, 28)
    w2 = zero_mean((n, k), n, 29)
    image = torch.cat([mc.pack_wgmma_slabs(torch.from_numpy(v), n)
                       for v in (w1, w2)]).numpy()
    ring = Ring(image, n)
    regs = to_regs(x)
    mid = acc_to_regs(ring.product(regs))
    for h in range(k // n):
        regs[h * (n // 16):(h + 1) * (n // 16)] = acc_to_regs(ring.product(mid))
    assert ring.next == mc.ring_smem_plan("pair_chain")["slabs_a_step"] == 12
    want = bf16(bf16(x @ w1.astype(np.float64)) @ w2.astype(np.float64))
    assert np.array_equal(from_regs(regs), want)


def test_ring_smem_plan_fits():
    """The ring's shared memory, as the kernel source computes it: the
    chain 1,024 + 7 × 16,384 + 2 × 50,176 + 7 × 16 (an eighth slot would
    pass the block's 232,448 B), the pair 1,024 + 8 × 24,576 + 8 × 16; the
    staged variants' stages (3 and 2 copies a warpgroup) leave no room for
    two warpgroups and a ring of 2."""
    chain, pair = mc.ring_smem_plan("matmul_chain"), mc.ring_smem_plan("pair_chain")
    assert (chain["ring_slots"], chain["smem_bytes"]) == (7, 216176)
    assert chain["smem_bytes"] + 16384 + 16 > 232448
    assert (pair["ring_slots"], pair["smem_bytes"]) == (8, 197760)
    for copies, k, slab in ((3, 512, 16384), (2, 384, 24576)):
        assert 1024 + 2 * 2 * 64 * (copies * k + 8) + 2 * (slab + 16) > 232448


@pytest.mark.parametrize("name", mc.KERNELS)
def test_designs_on_cpu(name):
    """On the CPU every design runs the plain version and counts nothing;
    an unknown design, and "multicast" off the ring's unstaged shape,
    raise."""
    k, n = mc.RING_SHAPES[name]
    x = torch.from_numpy(zero_mean((24, k), 1, 30)).bfloat16()
    ws = ((torch.from_numpy(zero_mean((k, k), k, 31)).bfloat16(),)
          if name == "matmul_chain" else
          (torch.from_numpy(zero_mean((k, n), k, 31)).bfloat16(),
           torch.from_numpy(zero_mean((n, k), n, 32)).bfloat16()))
    counts = [dict(c) for c in (mc.LAUNCHES, mc.LAUNCHES_RING,
                                mc.LAUNCHES_MULTICAST, mc.LAUNCHES_MMA)]
    want = mc.REFERENCES[name](x, *ws, 2)
    for design in mc.DESIGNS:
        assert torch.equal(mc.WRAPPERS[name](x, *ws, 2, design=design), want)
    assert mc.on_ring(name, k, n, False) and not mc.on_ring(name, k, n, True)
    with pytest.raises(ValueError, match="design"):
        mc.WRAPPERS[name](x, *ws, 2, design="ring")
    with pytest.raises(ValueError, match="multicast"):
        mc.WRAPPERS[name](x, *ws, 2, stage=True, design="multicast")
    small = x[:, :64].contiguous()
    sws = tuple(w[:64, :64].contiguous() for w in ws)
    with pytest.raises(ValueError, match="multicast"):
        mc.WRAPPERS[name](small, *sws, 2, design="multicast")
    assert counts == [dict(c) for c in (mc.LAUNCHES, mc.LAUNCHES_RING,
                                        mc.LAUNCHES_MULTICAST, mc.LAUNCHES_MMA)]


def test_pack_fragments_is_a_permutation():
    w = torch.arange(32 * 48, dtype=torch.float32).reshape(32, 48)
    packed = mc.pack_fragments(w).reshape(2, 3, 32, 8)
    # lane 4g + t of slab (kt, nt): rows 2t, 2t+1, 2t+8, 2t+9 of column
    # 16nt + g, then of column 16nt + 8 + g
    kt, nt, g, t = 1, 2, 5, 3
    want = [w[16 * kt + r, 16 * nt + 8 * j + g].item()
            for j in range(2) for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
    assert packed[kt, nt, 4 * g + t].tolist() == want
    assert sorted(packed.flatten().tolist()) == w.flatten().tolist()


@pytest.mark.parametrize("bad,err", [
    (lambda x, w: (x.float(), w.float()), TypeError),
    (lambda x, w: (x, w[:, :32].contiguous()), ValueError),
    (lambda x, w: (x[:, :40].contiguous(), w[:40, :40].contiguous()), ValueError),
    (lambda x, w: (x[:, ::2], w[::2, ::2]), ValueError),
    (lambda x, w: (x[:0], w), ValueError),
    (lambda x, w: (x[0], w), ValueError),
])
def test_chain_checks_raise(bad, err):
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(err):
        mc.matmul_chain(*bad(x, w), 2)


def test_pair_checks_raise():
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    w1 = torch.zeros(64, 32, dtype=torch.bfloat16)
    w2 = torch.zeros(32, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mc.pair_chain(x, w1, w1, 2)                   # w2 must be (N, K)
    with pytest.raises(ValueError):
        mc.pair_chain(x, w1, w2, -1)
    big = torch.zeros(528, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mc.pair_chain(x, big.T.contiguous(), big, 1)  # N over 512
    with pytest.raises(RuntimeError, match="unsupported device"):
        mc.pair_chain(x.to("meta"), w1.to("meta"), w2.to("meta"), 1)


def test_bench_chains_on_cpu(capsys):
    assert bench.main(["--device", "cpu", "--m", "64", "--ks", "32", "--lo",
                       "1", "--hi", "3", "--runs", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["bench"] for ln in lines] == list(bench.CHAIN_VARIANTS)
    for ln in lines:
        assert {"bench", "k", "n", "tf_s", "ms_lo", "ms_hi", "m", "device",
                "card", "bound_ms_hi", "rows_per_block", "finite"} <= set(ln)
        assert (ln["k"], ln["n"], ln["m"]) == (32, 32, 64)
        assert ln["device"] == ln["card"] == "cpu" and ln["finite"]
        assert ln["ms_lo"] > 0 and ln["ms_hi"] > 0 and ln["bound_ms_hi"] > 0
        assert ln["rows_per_block"] is None


def test_bench_pairs_on_cpu(capsys):
    assert bench.main(["--device", "cpu", "--m", "64", "--pairs", "32x16",
                       "--lo", "1", "--hi", "3", "--runs", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["bench"] for ln in lines] == list(bench.PAIR_VARIANTS)
    for ln in lines:
        assert (ln["k"], ln["n"], ln["m"]) == (32, 16, 64) and ln["finite"]
        # 4·M·K·N per step at the hi repeat count, over the H100's peak
        assert ln["bound_ms_hi"] == pytest.approx(
            max(4 * 64 * 32 * 16 * 3 / 989e12,
                (2 * 64 * 32 * 2 + 2 * 32 * 16 * 2) / 3.35e12) * 1e3)


def test_bench_scales_weights_so_the_chain_stays_finite():
    """``bench_mxu.py`` feeds unscaled uniform data, which overflows bf16
    within tens of steps; the port scales W by 2/K (w1 by 2/K, w2 by
    2/N), as ``bench_peak.py`` does."""
    x, (w,) = bench.inputs(np.random.default_rng(0), 64, 96, None, "cpu")
    assert float(w.float().sum(0).mean()) == pytest.approx(1.0, rel=0.1)
    assert torch.isfinite(mc.matmul_chain(x, w, 64).float()).all()
    unscaled = (w.float() * 96 / 2).bfloat16()
    assert not torch.isfinite(mc.matmul_chain(x, unscaled, 64).float()).all()


def test_peak_runs_on_cpu():
    lines = []
    summary = peak_bench.peak(shapes=((32, 16, (1, 2, 4)),), runs=1,
                              device="cpu", emit=lines.append)
    assert [ln["bench"] for ln in lines] == ["peak_chain", "peak_summary"]
    assert lines[0]["m"] == 32 and lines[0]["k"] == 16
    assert set(lines[0]["min_times_ms"]) == {"1", "2", "4"}
    assert summary["data_sheet_tf_s"] == 989.0 and summary["card"] == "cpu"
    assert set(summary["per_shape"]) == {"32x16x16"}
