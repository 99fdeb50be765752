"""SR inference engine for the ``rrdbnet`` and ``swinir`` families (the
port of ``s2sr_tpu/models/engine.py``).

Contract, as in the JAX engine:
- input uint8 (H, W, 3), output uint8 (sH, sW, 3);
- ``/255`` in, ``trunc(clip(x·255))`` out (truncation, not rounding);
- the network sees **BGR** (channel flip), so released weights give the
  reference's pixels;
- images with ``H·W`` above the engage area are halo-tiled. RRDBNet:
  area ``tile²·4``, and smaller images zero-pad to a 64-multiple bucket
  with a 0/1 mask, which is exact. SwinIR: area
  ``max(tile²·4, SWINIR_EXACT_AREA)`` (its tiled path is approximate),
  smaller images run the exact per-shape forward, and the halo is at
  least 16 px.

The serving path (:meth:`SREngine.enhance_serving`) cuts every image
into fixed windows that run in power-of-two chunks of at most
``batch_size``; each chunk's trunk runs its 69 residual dense blocks, or
36 Swin blocks, through the hand-written kernels. PyTorch runs eagerly,
so there is no per-shape compile; the engine runs on ``cuda`` unless
``device="cpu"``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.tiling import TilePlan, bucket_pad, tiled_apply
from ..utils import setup_logging
from .registry import get_model_config
from .rrdbnet import RRDBNet
from .swinir import SwinIR
from .weights import resolve_params, swinir_kwargs

logger = setup_logging("s2sr_tpu_torch.engine")

# Per-checkpoint halo-exactness guard: a loaded checkpoint whose tiled
# forward drifts from the whole-image forward by more than this many
# output LSBs at the configured pad gets the next pad of the ladder.
_HALO_MARGIN_MAX_LSB = 0.25
_HALO_PAD_LADDER = (6, 8, 10)
_MAX_INFLIGHT = 3
# SwinIR's tiled path is approximate at any halo, so images up to this
# area run the exact whole-image forward (engine.py of the JAX package)
SWINIR_EXACT_AREA = 2560 * 2560


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without CUDA raises
    (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def probe_halo_margin(model: RRDBNet, scale: int, pad: int, device, *,
                      probe_tile: int = 32, probe_size: int = 96) -> float:
    """Max float deviation, in LSBs of the 0-255 output scale, between the
    whole-image forward and the pad-``pad`` halo-tiled forward on a fixed
    synthetic probe image (tile 32: a smaller window sees less context,
    so the probe bounds the serving margin)."""
    from ..fetch.synthetic import synthetic_fields

    img = torch.from_numpy(synthetic_fields(size=(probe_size, probe_size),
                                            seed=7)).to(device).float() / 255.0
    whole = model(img[None])[0]
    tiled = tiled_apply(model, img, tile=probe_tile, pad=pad, scale=scale,
                        batch_size=16)
    return float((whole - tiled).abs().max().item() * 255.0)


# margins memoized per (weight file, pad, dtype) within the process
_PROBE_MEMO: dict = {}


def weights_fingerprint(weights_dir, model_name: str) -> str | None:
    """Identity of the loaded checkpoint file (path + size + mtime)."""
    for suffix in (".npz", ".pth"):
        f = Path(weights_dir) / f"{model_name}{suffix}"
        try:
            st = f.stat()
        except OSError:
            continue
        return f"{f.resolve()}:{st.st_size}:{st.st_mtime_ns}"
    return None


def _memoized_probe(fingerprint, model, scale, dtype, pad, device) -> float:
    if fingerprint is None:
        return probe_halo_margin(model, scale, pad, device)
    key = f"{fingerprint}|pad={pad}|dtype={dtype}"
    if key not in _PROBE_MEMO:
        _PROBE_MEMO[key] = probe_halo_margin(model, scale, pad, device)
    return _PROBE_MEMO[key]


class SREngine:
    """A loaded RRDBNet or SwinIR super-resolution model on one device."""

    def __init__(
        self,
        model_name: str = "realesrgan_x4",
        weights_dir: Path | str = "models",
        tile_size: int = 256,
        tile_pad: int = 4,
        batch_size: int = 16,
        dtype: str = "bfloat16",
        bgr_order: bool = True,
        pad_probe: bool = True,
        exact_area: int | None = None,
        device: str | torch.device = "cuda",
    ):
        config = get_model_config(model_name)
        self.family = config["family"]
        if self.family not in ("rrdbnet", "swinir"):
            raise ValueError(
                f"SREngine drives rrdbnet/swinir models, got {model_name}")
        if dtype == "int8" and self.family == "swinir":
            raise ValueError("dtype='int8' is only supported for rrdbnet")
        if dtype == "int8":
            raise NotImplementedError(
                "the int8-mixed trunk is not ported yet (ROADMAP queue 1 "
                "item 8)")
        if dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
        self.device = resolve_device(device)
        self.model_name = model_name
        self.scale = config["scale"]
        self.tile_size = tile_size
        self.tile_pad = tile_pad
        self.batch_size = batch_size
        self.dtype = torch.float32 if dtype == "float32" else torch.bfloat16
        self.bgr_order = bgr_order
        if exact_area is not None:
            self.engage_area = int(exact_area)
        elif self.family == "swinir":
            self.engage_area = max(tile_size * tile_size * 4,
                                   SWINIR_EXACT_AREA)
        else:
            self.engage_area = tile_size * tile_size * 4
        # batches beyond 16 windows run the RRDBNet upsample tail in
        # groups of 16
        self.up_sub = 16 if batch_size > 16 else None
        self.chunks_dispatched = 0

        sd, self.pretrained = resolve_params(model_name, weights_dir)
        if self.family == "swinir":
            # halo 16, as the reference's SwinIR wrapper
            self.tile_pad = max(tile_pad, 16)
            self.model = SwinIR(**swinir_kwargs(config), dtype=self.dtype)
        else:
            self.model = RRDBNet(
                num_in_ch=config.get("num_in_ch", 3),
                num_feat=config["channels"], num_block=config["blocks"],
                num_grow_ch=config["growth"], scale=self.scale,
                dtype=self.dtype)
        self.model.load_state_dict(sd)
        self.model.to(self.device).eval().pack()
        if not self.pretrained:
            logger.warning(
                "%s: no converted weights in %s — using random init "
                "(offline environment); drop the released .pth there for "
                "real quality", model_name, weights_dir)

        # halo-exactness guard for loaded RRDBNet checkpoints (random init
        # skips; SwinIR's tiled path is approximate, so it has no probe)
        self.halo_margin_lsb: float | None = None
        if (pad_probe and self.family == "rrdbnet" and self.pretrained
                and self.tile_pad < max(_HALO_PAD_LADDER)):
            fp = weights_fingerprint(weights_dir, model_name)

            def probe(pad):
                return _memoized_probe(fp, self.model, self.scale,
                                       self.dtype, pad, self.device)

            self.halo_margin_lsb = margin = probe(self.tile_pad)
            # NaN-safe: an exploding checkpoint probes to NaN = unsafe
            if not margin <= _HALO_MARGIN_MAX_LSB:
                for pad_try in _HALO_PAD_LADDER:
                    if pad_try <= self.tile_pad:
                        continue
                    margin = probe(pad_try)
                    if (margin <= _HALO_MARGIN_MAX_LSB
                            or pad_try == _HALO_PAD_LADDER[-1]):
                        logger.warning(
                            "%s: halo margin %.3g LSB at pad %d exceeds the "
                            "byte-exactness threshold (%.2g) — using pad %d "
                            "(margin %.3g)", model_name, self.halo_margin_lsb,
                            self.tile_pad, _HALO_MARGIN_MAX_LSB, pad_try,
                            margin)
                        self.tile_pad = pad_try
                        self.halo_margin_lsb = margin
                        break

    # -- model and uint8 contract ----------------------------------------

    def _fwd(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        if self.family == "swinir":
            return self.model(x)
        return self.model(x, mask=mask, up_sub_batch=self.up_sub)

    def _to_float(self, img_u8: torch.Tensor) -> torch.Tensor:
        x = img_u8.float() / 255.0
        return x.flip(-1) if self.bgr_order else x

    def _to_u8(self, out: torch.Tensor) -> torch.Tensor:
        if self.bgr_order:
            out = out.flip(-1)
        return torch.trunc(torch.clamp(out * 255.0, 0.0, 255.0)).to(torch.uint8)

    def _chunk(self, wins: np.ndarray, masks: np.ndarray | None):
        """(n, wh, ww, 3) uint8 windows → (n, s·wh, s·ww, 3) uint8 on the
        device, enqueued; with ``masks`` the exact masked-bucket path."""
        x = self._to_float(torch.from_numpy(np.ascontiguousarray(wins))
                           .to(self.device))
        mask = None
        if masks is not None:
            mask = torch.from_numpy(np.ascontiguousarray(masks)).to(self.device)
            x = x * mask           # the zero-pad region must be exactly zero
        self.chunks_dispatched += 1
        return self._to_u8(self._fwd(x, mask))

    # -- exact per-shape path ----------------------------------------------

    @torch.no_grad()
    def enhance_device(self, img: torch.Tensor) -> torch.Tensor:
        """uint8 (H, W, 3) tensor on the device → uint8 (sH, sW, 3) tensor."""
        x = self._to_float(img)
        h, w, _ = x.shape
        s = self.scale
        if h * w > self.engage_area:
            out = tiled_apply(self._fwd, x, tile=self.tile_size,
                              pad=self.tile_pad, scale=s,
                              batch_size=self.batch_size)
        elif self.family == "swinir":
            out = self._fwd(x[None])[0]
        else:
            hb, wb = -(-h // 64) * 64, -(-w // 64) * 64
            if hb == h and wb == w:
                out = self._fwd(x[None])[0]
            else:
                xp = F.pad(x, (0, 0, 0, wb - w, 0, hb - h))
                mask = torch.zeros(hb, wb, 1, device=x.device)
                mask[:h, :w] = 1.0
                out = self._fwd(xp[None], mask[None])[0][:h * s, :w * s]
        return self._to_u8(out)

    def enhance(self, img: np.ndarray) -> np.ndarray:
        """Host-array wrapper of :meth:`enhance_device`."""
        out = self.enhance_device(torch.from_numpy(np.ascontiguousarray(img))
                                  .to(self.device))
        return out.cpu().numpy()

    # -- bucketed serving path ----------------------------------------------

    @torch.no_grad()
    def _run_chunked(self, wins: np.ndarray,
                     masks: np.ndarray | None = None) -> np.ndarray:
        """(N, wh, ww, 3) uint8 windows → (N, s·wh, s·ww, 3) uint8, in
        power-of-two chunks ≤ ``batch_size`` (N's binary decomposition
        plus repeated full chunks), with at most three chunk outputs on
        the device while the host copies earlier ones back."""
        n = wins.shape[0]
        pending: list = []
        outs = []
        k = 0
        while k < n:
            step = self.batch_size
            while step > n - k:
                step //= 2
            step = max(step, 1)
            pending.append(self._chunk(
                wins[k:k + step], None if masks is None else masks[k:k + step]))
            while len(pending) >= _MAX_INFLIGHT:
                outs.append(pending.pop(0).cpu().numpy())
            k += step
        outs.extend(o.cpu().numpy() for o in pending)
        return np.concatenate(outs, axis=0)[:n]

    def _serving_parts(self, img: np.ndarray):
        """(windows, stitch-meta) for the bucketed path, or None when the
        image needs the exact per-shape path (skinny shapes)."""
        h, w, _ = img.shape
        win = self.tile_size + 2 * self.tile_pad
        if h * w <= self.engage_area:
            if self.family == "swinir":
                return None             # the exact per-shape path
            padded, mask = bucket_pad(img)
            return padded[None], {"kind": "small", "h": h, "w": w,
                                  "mask": mask[None]}
        if min(h, w) < win:
            return None
        plan = TilePlan.for_image(h, w, tile=self.tile_size,
                                  pad=self.tile_pad, scale=self.scale)
        wins = np.empty((plan.num_windows, plan.win_h, plan.win_w, 3),
                        img.dtype)
        for i, (y, x) in enumerate(plan.starts()):
            wins[i] = img[y:y + plan.win_h, x:x + plan.win_w]
        return wins, {"kind": "tiled", "plan": plan, "h": h, "w": w}

    def _serving_stitch(self, outs: np.ndarray, meta: dict) -> np.ndarray:
        s = self.scale
        if meta["kind"] == "small":
            return outs[0][:meta["h"] * s, :meta["w"] * s]
        return meta["plan"].stitch_host(outs)

    def enhance_serving(self, img: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) → uint8 (sH, sW, 3) through fixed windows:
        byte-identical to :meth:`enhance` for tiled images, bit-identical
        to the exact forward for bucketed ones."""
        parts = self._serving_parts(img)
        if parts is None:
            return self.enhance(img)
        wins, meta = parts
        return self._serving_stitch(self._run_chunked(wins, meta.get("mask")),
                                    meta)

    def enhance_serving_many(self, imgs: list) -> list:
        """Batch-coalesced serving: windows of all images with the same
        window shape share chunks; each result equals
        :meth:`enhance_serving` of its image."""
        parts = [self._serving_parts(im) for im in imgs]
        results: list = [None] * len(imgs)
        groups: dict = {}
        for i, p in enumerate(parts):
            if p is None:
                results[i] = self.enhance(imgs[i])
            else:
                groups.setdefault((p[1]["kind"], p[0].shape[1:3]),
                                  []).append(i)
        for (kind, _), idxs in groups.items():
            wins = np.concatenate([parts[i][0] for i in idxs], axis=0)
            masks = (np.concatenate([parts[i][1]["mask"] for i in idxs],
                                    axis=0) if kind == "small" else None)
            outs = self._run_chunked(wins, masks)
            off = 0
            for i in idxs:
                k = parts[i][0].shape[0]
                results[i] = self._serving_stitch(outs[off:off + k],
                                                  parts[i][1])
                off += k
        return results


_ENGINE_CACHE: dict = {}


def get_engine(model_name: str = "realesrgan_x4", **kwargs) -> SREngine:
    """Process-wide engine cache; execution knobs the caller leaves out
    come from :func:`get_settings` before the cache key is formed."""
    from ..config import get_settings

    settings = get_settings()
    kwargs.setdefault("tile_size", settings.sr_tile_size)
    kwargs.setdefault("tile_pad", settings.sr_tile_pad)
    kwargs.setdefault("batch_size", settings.sr_batch_size)
    kwargs.setdefault("dtype", settings.sr_dtype)
    kwargs.setdefault("pad_probe", settings.sr_pad_probe)
    kwargs.setdefault("device", "cuda")
    if settings.sr_exact_area:
        kwargs.setdefault("exact_area", settings.sr_exact_area)
    kwargs["device"] = str(resolve_device(kwargs["device"]))
    key = (model_name, tuple(sorted(kwargs.items())))
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE[key] = SREngine(model_name, **kwargs)
    return _ENGINE_CACHE[key]
