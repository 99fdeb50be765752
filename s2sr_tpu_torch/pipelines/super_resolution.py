"""Standard SR pipeline: the classic models (EDSR, ESPCN, LapSRN).

The port of ``s2sr_tpu/pipelines/super_resolution.py`` (the reference's
``cv2.dnn_superres`` path): model registry dispatch, raster read, SR,
rescaled-transform save, the same metadata keys and sidecar JSON. The
models are :mod:`s2sr_tpu_torch.models.classic` on the card (unless the
caller passes ``device="cpu"``); their weights come from a ``.npz`` in
the JAX package's layout, else a frozen ``.pb`` read without TensorFlow,
else a seeded random init.

The uint8 contract here is ``clip(round(out · 255))`` with rounding half
to even, as in JAX — not the RRDBNet engine's truncation. Sizes off the
64 grid run in the next 64-multiple bucket with the exact-padding mask,
so the result equals the unpadded forward; images on the grid skip the
mask.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.classic import EDSR, ESPCN, LapSRN, build_classic_model
from ..models.engine import resolve_device
from ..models.registry import get_model_config
from ..models.weights import load_npz_tree, params_from_jax_classic
from ..ops.color import rgb_to_ycrcb_f32, ycrcb_to_rgb_f32
from ..ops.resize import upscale_cubic
from ..utils import StageTimer, setup_logging
from .io import load_rgb, save_sr_output

logger = setup_logging("s2sr_tpu_torch.super_resolution")

BUCKET = 64

_MODEL_CACHE: dict = {}


def create_sr_model(model: str = "edsr", scale: int = 4,
                    device: str = "cuda") -> torch.nn.Module:
    """The classic family member ``{model}_x{scale}`` on ``device``, in
    eval mode. Cached per process, keyed on the weight files' mtimes (a
    dropped ``.npz`` or ``.pb`` is picked up) and the device."""
    from ..config import get_settings

    name = f"{model}_x{scale}"
    config = get_model_config(name)
    dev = resolve_device(device)
    wdir = Path(get_settings().weights_dir)

    def stamp(p: Path):
        try:
            return p.stat().st_mtime_ns
        except OSError:
            return None

    key = (name, str(wdir), stamp(wdir / f"{name}.npz"),
           stamp(wdir / f"{name}.pb"), str(dev))
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = _build_sr_model(name, config, scale, wdir) \
            .to(dev).eval()
    return _MODEL_CACHE[key]


def _model_for_tree(family: str, scale: int, tree: dict) -> torch.nn.Module:
    """The module whose shapes are the JAX-layout ``tree``'s (JAX's
    models take their widths from the params they are given)."""
    if family == "edsr":
        return EDSR(scale=scale, num_feat=tree["head"]["kernel"].shape[3],
                    num_blocks=tree["body"]["conv1"]["kernel"].shape[0])
    if family == "espcn":
        return ESPCN(scale=scale, num_ch=tree["conv1"]["kernel"].shape[2])
    head = tree["head"]["kernel"]
    return LapSRN(scale=scale, num_feat=head.shape[3],
                  depth_per_level=len(tree["levels"][0]["embed"]),
                  num_ch=head.shape[2])


def _build_sr_model(name: str, config: dict, scale: int,
                    weights_dir: Path) -> torch.nn.Module:
    npz = weights_dir / f"{name}.npz"
    pb = weights_dir / f"{name}.pb"
    family = config["family"]
    mean = None
    if npz.exists():
        tree = load_npz_tree(npz)
    elif pb.exists():
        # frozen TF GraphDef, read without TensorFlow (models/pb_reader)
        from ..models.pb_reader import (convert_edsr_pb, convert_espcn_pb,
                                        convert_lapsrn_pb)

        if family == "edsr":
            tree, inferred = convert_edsr_pb(pb, scale)
            mean = inferred.get("mean")
            if mean is not None and not mean.max() > 1.0:
                mean = mean * 255.0  # EDSR runs in the graph's 0-255 domain
        elif family == "espcn":
            tree = convert_espcn_pb(pb, scale)
        elif family == "lapsrn":
            tree = convert_lapsrn_pb(pb, scale)
        else:
            raise ValueError(f"no .pb converter for family {family}")
        logger.info("%s: converted frozen GraphDef %s", name, pb)
    else:
        logger.warning("%s: no converted weights — random init", name)
        return build_classic_model(name, config)
    model = _model_for_tree(family, scale, tree)
    model.load_state_dict(params_from_jax_classic(tree, family, mean=mean))
    return model


def _bucketed_forward(model, arr: torch.Tensor) -> torch.Tensor:
    """(H, W, C) float on the model's device → (sH, sW, C) float32 via
    the 64-multiple bucket and its exact-padding mask; on-grid inputs
    skip the mask."""
    h, w, _ = arr.shape
    s = model.scale
    if h % BUCKET == 0 and w % BUCKET == 0:
        return model(arr[None])[0]
    hb, wb = -(-h // BUCKET) * BUCKET, -(-w // BUCKET) * BUCKET
    xp = F.pad(arr, (0, 0, 0, wb - w, 0, hb - h))
    mask = torch.zeros(hb, wb, 1, device=arr.device)
    mask[:h, :w] = 1.0
    return model(xp[None], mask[None])[0][:h * s, :w * s]


def _to_u8(out: torch.Tensor) -> np.ndarray:
    """float [0, 1] → uint8 ``clip(round(out · 255))``, half to even."""
    return torch.round(out * 255.0).clamp(0, 255).to(torch.uint8) \
        .cpu().numpy()


def _net_input(model, img: np.ndarray):
    """uint8 (H, W, 3) → (the float array the net sees on the device,
    the chroma to upscale or None): float [0, 1] RGB, or for a 1-channel
    model the Y of cv2's float YCrCb with its Cr/Cb."""
    x01 = torch.from_numpy(np.asarray(img).astype(np.float32) / 255.0) \
        .to(next(model.parameters()).device)
    if model.num_ch != 1:
        return x01, None
    ycc = rgb_to_ycrcb_f32(x01)
    return ycc[..., :1], ycc[..., 1:]


def _merge(model, y: torch.Tensor, chroma) -> np.ndarray:
    """The net's output (and the cubic-upscaled chroma of a luma model)
    → uint8 RGB."""
    if chroma is not None:
        y = ycrcb_to_rgb_f32(torch.cat(
            [y, upscale_cubic(chroma, model.scale)], dim=-1))
    return _to_u8(y)


def run_classic_sr(model, img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) → uint8 (sH, sW, 3) through a classic model.

    A 1-channel model (the released ESPCN/LapSRN luma graphs) runs the
    reference's ``cv2.dnn_superres`` flow: float [0, 1] YCrCb, the net on
    Y, INTER_CUBIC chroma, merged back to RGB."""
    net, chroma = _net_input(model, img)
    return _merge(model, _bucketed_forward(model, net), chroma)


def run_classic_sr_many(model, imgs) -> list:
    """Batched classic serving: N images through one forward per
    64-multiple bucket group (mixed sizes group by bucket), each result
    byte-equal to :func:`run_classic_sr` on its image (the same bucket
    and mask arithmetic)."""
    scale = model.scale
    inputs = [_net_input(model, img) for img in imgs]
    groups: dict = {}
    for i, (net, _) in enumerate(inputs):
        h, w, _ = net.shape
        groups.setdefault((-(-h // BUCKET) * BUCKET,
                           -(-w // BUCKET) * BUCKET), []).append(i)
    sr: list = [None] * len(inputs)
    for (hb, wb), idxs in groups.items():
        nets = [inputs[i][0] for i in idxs]
        if all(n.shape[:2] == (hb, wb) for n in nets):
            out = model(torch.stack(nets))
        else:
            xs = torch.stack([F.pad(n, (0, 0, 0, wb - n.shape[1],
                                        0, hb - n.shape[0])) for n in nets])
            masks = torch.zeros(len(nets), hb, wb, 1, device=xs.device)
            for j, n in enumerate(nets):
                masks[j, :n.shape[0], :n.shape[1]] = 1.0
            out = model(xs, masks)
        for j, i in enumerate(idxs):
            h, w, _ = inputs[i][0].shape
            sr[i] = out[j][:h * scale, :w * scale]
    return [_merge(model, y, chroma) for y, (_, chroma) in zip(sr, inputs)]


def apply_super_resolution(
    input_path: Path | str,
    output_path: Path | str,
    scale: int = 4,
    model: str = "edsr",
    device: str = "cuda",
) -> Tuple[Path, dict]:
    """Read → SR → save (``super_resolution.py:127-257`` of the
    reference)."""
    logger.info("Super-resolution (%s x%d): %s", model.upper(), scale,
                input_path)
    timer = StageTimer(total_stages=2)
    img, transform, crs = load_rgb(input_path)

    with timer.stage(f"{model.upper()} x{scale}"):
        net = create_sr_model(model, scale, device=device)
        out_u8 = run_classic_sr(net, img)

    final = save_sr_output(out_u8, Path(output_path), transform, crs, scale)
    metadata = {
        "model": f"{model.upper()}_x{scale}",
        "scale": scale,
        "input_size": [img.shape[1], img.shape[0]],
        "output_size": [out_u8.shape[1], out_u8.shape[0]],
        "original_resolution_m": 10.0,
        "effective_resolution_m": 10.0 / scale,
        "timing": timer.summary(),
    }
    return final, metadata


def process_sentinel2_sr(
    input_tif: Path | str,
    output_dir: Path | str,
    scale: int = 4,
    model: str = "edsr",
    device: str = "cuda",
) -> dict:
    """:func:`apply_super_resolution` plus the sidecar metadata JSON."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    base = Path(input_tif).stem
    out_path = output_dir / f"{base}_sr_x{scale}"
    final, metadata = apply_super_resolution(input_tif, out_path, scale,
                                             model, device=device)
    result = {
        "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        "input": str(input_tif),
        "outputs": {"sr_tif": str(final) if final.suffix == ".tif" else None,
                    "sr_png": str(final.with_suffix(".png"))
                    if final.with_suffix(".png").exists() else None},
        "sr_metadata": metadata,
    }
    with open(output_dir / f"{base}_sr_metadata.json", "w") as f:
        json.dump(result, f, indent=2)
    return result
