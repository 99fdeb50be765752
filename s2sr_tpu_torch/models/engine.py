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

With a mesh (``SREngine(mesh=...)``, or ``Settings.mesh_shape`` through
:func:`get_engine`) the engine holds one model replica per ``dp``
coordinate and sends window chunks round-robin over them, in the tiled
path (``parallel/tiling.py::tiled_apply``) and in the serving path
alike; each replica runs whole chunks, so with ``sp = 1`` the output is
the one-device output byte for byte. With ``sp > 1`` a replica is the
``sp`` devices of its ``dp`` coordinate, a model copy on each: every
chunk's windows are split over H into bands, one per device, which run
the band forward (``rrdbnet.py::rrdbnet_bands``,
``swinir.py::swinir_bands``: halo rows exchanged before every conv and
residual dense block, a shifted Swin block's roll across the bands),
and are joined again. :meth:`SREngine.enhance` runs an image below the
engage area whole on the mesh's first device, as JAX's untiled branch
does; the serving path's bucketed small images run in bands like any
chunk.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import threading
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial
from ..parallel.tiling import TilePlan, bucket_pad, tiled_apply
from ..utils import setup_logging
from .registry import get_model_config
from .rrdbnet import RRDBNet, rrdbnet_bands
from .swinir import SwinIR, swinir_bands
from .weights import resolve_params, rrdbnet_dims, swinir_kwargs

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


# Margins memoized per (weight file, pad, dtype): in the process, and in
# a JSON sidecar (``$S2SR_TORCH_CACHE/halo_probe.json``, by default under
# ``~/.cache/s2sr_tpu_torch``) so a later process skips the probe.
_PROBE_MEMO: dict = {}


def _probe_store_path() -> Path:
    root = os.environ.get("S2SR_TORCH_CACHE",
                          Path.home() / ".cache" / "s2sr_tpu_torch")
    return Path(root) / "halo_probe.json"


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
    if key in _PROBE_MEMO:
        return _PROBE_MEMO[key]
    store = _probe_store_path()
    try:
        disk = json.loads(store.read_text())
    except (OSError, ValueError):
        disk = {}
    if key in disk:
        _PROBE_MEMO[key] = float(disk[key])
        return _PROBE_MEMO[key]
    margin = _PROBE_MEMO[key] = probe_halo_margin(model, scale, pad, device)
    disk[key] = margin
    try:
        store.parent.mkdir(parents=True, exist_ok=True)
        store.write_text(json.dumps(disk))
    except OSError as exc:      # the sidecar saves time, it is not needed
        logger.warning("halo probe sidecar not written: %s", exc)
    return margin


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
        mesh=None,
    ):
        config = get_model_config(model_name)
        self.family = config["family"]
        if self.family not in ("rrdbnet", "swinir"):
            raise ValueError(
                f"SREngine drives rrdbnet/swinir models, got {model_name}")
        if dtype == "int8" and self.family == "swinir":
            raise ValueError("dtype='int8' is only supported for rrdbnet")
        if dtype not in ("bfloat16", "float32", "int8"):
            raise ValueError(f"dtype must be bfloat16, float32 or int8, "
                             f"got {dtype}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.model_name = model_name
        self.scale = config["scale"]
        self.tile_size = tile_size
        self.tile_pad = tile_pad
        self.batch_size = batch_size
        # "int8": the int8-mixed trunk (rrdbnet_int8.py) in bfloat16
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
            # sized from the loaded weights, as JAX's stateless apply
            # is: a trained checkpoint of any depth may sit under a
            # registry name (the kernel's widths are checked by RRDBNet)
            self.model = RRDBNet(**rrdbnet_dims(sd), scale=self.scale,
                                 dtype=self.dtype)
        self.model.load_state_dict(sd)
        self.model.to(self.device).eval().pack()
        if not self.pretrained:
            logger.warning(
                "%s: no converted weights in %s — using random init "
                "(offline environment); drop the released .pth there for "
                "real quality", model_name, weights_dir)
        if dtype == "int8":
            self._quantize()
        # one replica per dp coordinate of the mesh: its sp group of
        # devices, one band each, with one model copy per device (the
        # first is self.model). SwinIR replicas keep the fused swin_block
        # kernel: JAX's mesh engine turns its Pallas block off only
        # because GSPMD cannot split a custom call, and the port's bands
        # tell the kernel their place (tests/test_torch_mesh.py and
        # tests/test_torch_sp.py hold it to JAX's mesh engine at the
        # SwinIR engine tests' tolerance)
        dp = 1 if mesh is None else mesh.axis_size("dp")
        self.replica_groups = tuple(
            (self.device,) if mesh is None else
            tuple(resolve_device(d) for d in mesh.sp_group(i))
            for i in range(dp))
        copies = {str(self.device): self.model}
        for g in self.replica_groups:
            for d in g:
                if str(d) not in copies:
                    copies[str(d)] = copy.deepcopy(self.model).to(d)
        # a mesh naming one device more than once shares its copy
        self.band_models = [[copies[str(d)] for d in g]
                            for g in self.replica_groups]
        self.replicas = [m[0] for m in self.band_models]
        self.band_unit = (self.model.window_size if self.family == "swinir"
                          else 1)
        self.replica_forwards = [0] * len(self.replicas)

        # halo-exactness guard for loaded RRDBNet checkpoints (random init
        # skips; SwinIR's tiled path is approximate, so it has no probe; an
        # int8 engine serves the quantized forward, which the float probe
        # does not measure)
        self.halo_margin_lsb: float | None = None
        if (pad_probe and self.family == "rrdbnet" and self.pretrained
                and not self.quantized
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

    def _quantize(self) -> None:
        """Calibrate once (one float32 forward, TF32 off, on the engine's
        device) on the JAX engine's input, ``synthetic_fields((256, 256),
        seed=42)`` in the channel order the trunk is served, and attach the
        int8-mixed trunk."""
        from ..fetch.synthetic import synthetic_fields
        from .rrdbnet_int8 import quantize_rrdbnet

        calib = torch.from_numpy(synthetic_fields(size=(256, 256), seed=42))
        calib = calib.to(self.device).float()[None] / 255.0
        if self.bgr_order:
            calib = calib.flip(-1)
        self.model.quantize(quantize_rrdbnet(self.model, calib))

    @property
    def quantized(self) -> bool:
        """Whether the model serves the int8-mixed trunk."""
        return getattr(self.model, "quantized", False)

    @property
    def precision(self) -> str:
        """The precision served: "int8", "bfloat16" or "float32"."""
        return "int8" if self.quantized else str(self.dtype).replace(
            "torch.", "")

    # -- model and uint8 contract ----------------------------------------

    def _fwd(self, x: torch.Tensor, mask: torch.Tensor | None = None,
             replica: int = 0) -> torch.Tensor:
        """The forward of a whole batch on the replica's first device."""
        return self._bands([x], None if mask is None else [mask], replica)[0]

    def _bands(self, xs: list, masks: list | None = None,
               replica: int = 0) -> list:
        """The replica's forward of a batch given as its bands of H from
        the top, band j on the replica's device j (``masks`` a list
        likewise, or None) → the list of the bands' outputs."""
        self.replica_forwards[replica] += 1
        models = self.band_models[replica][:len(xs)]
        if self.family == "swinir":
            return swinir_bands(models, xs)
        return rrdbnet_bands(models, xs, masks, up_sub_batch=self.up_sub)

    def _to_float(self, img_u8: torch.Tensor) -> torch.Tensor:
        x = img_u8.float() / 255.0
        return x.flip(-1) if self.bgr_order else x

    def _to_u8(self, out: torch.Tensor) -> torch.Tensor:
        if self.bgr_order:
            out = out.flip(-1)
        return torch.trunc(torch.clamp(out * 255.0, 0.0, 255.0)).to(torch.uint8)

    def _chunk(self, wins: np.ndarray, masks: np.ndarray | None,
               replica: int = 0) -> list:
        """(n, wh, ww, 3) uint8 windows → (n, s·wh, s·ww, 3) uint8 on the
        replica's device, enqueued, as the list of its bands from the top
        (one without ``sp``); with ``masks`` the exact masked-bucket
        path."""
        group = self.replica_groups[replica]
        bounds = spatial.band_bounds(wins.shape[1], len(group),
                                     self.band_unit)
        xs, ms = [], []
        for (a, b), dev in zip(bounds, group):
            x = self._to_float(torch.from_numpy(np.ascontiguousarray(
                wins[:, a:b])).to(dev))
            if masks is not None:
                ms.append(torch.from_numpy(np.ascontiguousarray(
                    masks[:, a:b])).to(dev))
                x = x * ms[-1]     # the zero-pad region must be exactly zero
            xs.append(x)
        self.chunks_dispatched += 1
        return [self._to_u8(o) for o in self._bands(xs, ms or None, replica)]

    # -- exact per-shape path ----------------------------------------------

    @torch.no_grad()
    def enhance_device(self, img: torch.Tensor) -> torch.Tensor:
        """uint8 (H, W, 3) tensor on the device → uint8 (sH, sW, 3) tensor."""
        x = self._to_float(img)
        h, w, _ = x.shape
        s = self.scale
        if h * w > self.engage_area:
            # tiled_apply hands a replica of one device its batch, and a
            # replica of sp devices the list of its bands
            fns = [functools.partial(self._bands if len(g) > 1 else self._fwd,
                                     replica=i)
                   for i, g in enumerate(self.replica_groups)]
            out = tiled_apply(fns, x, tile=self.tile_size, pad=self.tile_pad,
                              scale=s, batch_size=self.batch_size,
                              mesh=self.mesh, band_unit=self.band_unit)
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
        plus repeated full chunks), with at most three chunk outputs per
        replica on the device while the host copies earlier ones back; the
        chunks go round-robin over the replicas."""
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
                wins[k:k + step], None if masks is None else masks[k:k + step],
                self.chunks_dispatched % len(self.replicas)))
            while len(pending) >= _MAX_INFLIGHT * len(self.replicas):
                outs.append(_joined(pending.pop(0)))
            k += step
        outs.extend(_joined(o) for o in pending)
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


def _joined(bands: list) -> np.ndarray:
    """A chunk's output bands, copied to the host and joined over H."""
    return np.concatenate([b.cpu().numpy() for b in bands], axis=1)


_ENGINE_CACHE: dict = {}
# held while an engine is built, so two threads (the server's runner and
# a direct caller) never build the same engine twice
_ENGINE_LOCK = threading.Lock()


def loaded_engines() -> list:
    """Resident engines (``/api/metadata`` lists them: ``pretrained``
    false means random init because the weights were absent). A snapshot
    taken without the build lock, so a handler never waits for a build."""
    return list(_ENGINE_CACHE.values())


def get_engine(model_name: str = "realesrgan_x4", **kwargs) -> SREngine:
    """Process-wide engine cache; execution knobs the caller leaves out
    come from :func:`get_settings` before the cache key is formed. A
    ``Settings.mesh_shape`` (e.g. ``"dp=4"``, ``"dp=2,sp=2"``) spreads the
    window chunks over that mesh's ``dp`` replicas and each chunk's H
    over a replica's ``sp`` bands; the mesh's devices are part of the
    cache key."""
    from ..config import get_settings
    from ..parallel.mesh import build_mesh

    settings = get_settings()
    kwargs.setdefault("tile_size", settings.sr_tile_size)
    kwargs.setdefault("tile_pad", settings.sr_tile_pad)
    kwargs.setdefault("batch_size", settings.sr_batch_size)
    kwargs.setdefault("dtype", settings.sr_dtype)
    kwargs.setdefault("pad_probe", settings.sr_pad_probe)
    kwargs.setdefault("device", kwargs["mesh"].device
                      if kwargs.get("mesh") is not None else "cuda")
    if settings.sr_exact_area:
        kwargs.setdefault("exact_area", settings.sr_exact_area)
    kwargs["device"] = str(resolve_device(kwargs["device"]))
    if kwargs.get("mesh") is None and settings.mesh_shape:
        kwargs["mesh"] = build_mesh(settings.mesh_shape,
                                    device=kwargs["device"])
    mesh = kwargs.get("mesh")
    key = (model_name, None if mesh is None else mesh.key(),
           tuple(sorted((k, v) for k, v in kwargs.items() if k != "mesh")))
    with _ENGINE_LOCK:
        if key not in _ENGINE_CACHE:
            _ENGINE_CACHE[key] = SREngine(model_name, **kwargs)
        return _ENGINE_CACHE[key]
