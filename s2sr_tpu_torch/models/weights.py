"""RRDBNet weights for the port: ``.pth`` and flat-key ``.npz`` loading,
JAX param trees, and the deterministic random init.

The port's modules carry the released checkpoints' parameter names and
OIHW layout, so a ``.pth`` state dict needs only unwrapping. The JAX
package's trees (HWIO kernels, the RRDB stack on a leading ``body``
axis) and its ``.npz`` files (the same tree flattened with ``/`` keys)
map over with :func:`params_from_jax`. No download happens here.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_TOP_CONVS = ("conv_first", "conv_body", "conv_up1", "conv_up2",
              "conv_hr", "conv_last")


def convert_rrdbnet_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """A (possibly ``params_ema``/``params``-wrapped) released state dict
    → the port's state dict (same names, OIHW tensors)."""
    if "params_ema" in sd:
        sd = sd["params_ema"]
    elif "params" in sd:
        sd = sd["params"]
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .float() for k, v in sd.items()}


def load_torch_checkpoint(path: Path | str) -> Mapping[str, Any]:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _hwio_to_oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))))


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """A JAX ``rrdbnet`` param tree of numpy arrays (stacked ``body``
    axis, HWIO kernels) → the port's state dict."""
    sd: StateDict = {}
    for name in _TOP_CONVS:
        if name in tree:
            sd[f"{name}.weight"] = _hwio_to_oihw(tree[name]["kernel"])
            sd[f"{name}.bias"] = torch.from_numpy(
                np.array(tree[name]["bias"], np.float32))
    body = tree["body"]
    num_block = np.asarray(body["rdb1"]["conv1"]["kernel"]).shape[0]
    for i in range(num_block):
        for j in (1, 2, 3):
            for k in (1, 2, 3, 4, 5):
                p = body[f"rdb{j}"][f"conv{k}"]
                pre = f"body.{i}.rdb{j}.conv{k}"
                sd[f"{pre}.weight"] = _hwio_to_oihw(np.asarray(p["kernel"])[i])
                sd[f"{pre}.bias"] = torch.from_numpy(
                    np.array(np.asarray(p["bias"])[i], np.float32))
    return sd


# --- flat npz (the JAX package's layout) -------------------------------

def _listify(node):
    """Rebuild list nodes: a dict whose keys are exactly 0..n-1."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(int(k) for k in out)
        if idx == list(range(len(idx))):
            return [out[str(i)] for i in idx]
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return _listify(tree)


def load_npz_tree(path: Path | str) -> dict:
    """A flat-key ``.npz`` → nested dict of numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def load_params(path: Path | str) -> StateDict:
    """A JAX-layout rrdbnet ``.npz`` → the port's state dict."""
    return params_from_jax(load_npz_tree(path))


# --- random init --------------------------------------------------------

def init_state_dict(num_feat: int = 64, num_block: int = 23,
                    num_grow_ch: int = 32, num_in_ch: int = 3,
                    num_out_ch: int = 3, seed: int = 0) -> StateDict:
    """Deterministic scaled-Kaiming init with the checkpoint's shapes
    (``normal · sqrt(2/fan_in) · 0.1``, zero bias) from a
    ``torch.Generator`` seeded ``seed``. Its numbers differ from the
    JAX package's ``PRNGKey`` init."""
    g = torch.Generator().manual_seed(seed)
    sd: StateDict = {}

    def put(name, cin, cout):
        w = torch.randn(3, 3, cin, cout, generator=g)
        w = w * math.sqrt(2.0 / (9 * cin)) * 0.1
        sd[f"{name}.weight"] = w.permute(3, 2, 0, 1).contiguous()
        sd[f"{name}.bias"] = torch.zeros(cout)

    nf, gc = num_feat, num_grow_ch
    for i in range(num_block):
        for j in (1, 2, 3):
            for k in (1, 2, 3, 4, 5):
                cin = nf + (k - 1) * gc
                put(f"body.{i}.rdb{j}.conv{k}", cin, gc if k < 5 else nf)
    put("conv_first", num_in_ch, nf)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        put(name, nf, nf)
    put("conv_last", nf, num_out_ch)
    return sd


def resolve_params(model_name: str, weights_dir: Path | str,
                   seed: int = 0) -> tuple[StateDict, bool]:
    """A converted ``.npz`` if present, else a released ``.pth``, else
    the deterministic random init. Returns ``(state_dict, pretrained)``."""
    from .registry import get_model_config

    config = get_model_config(model_name)
    weights_dir = Path(weights_dir)
    npz = weights_dir / f"{model_name}.npz"
    if npz.exists():
        return load_params(npz), True
    pth = weights_dir / f"{model_name}.pth"
    if pth.exists():
        return convert_rrdbnet_state_dict(load_torch_checkpoint(pth)), True
    return init_state_dict(num_feat=config["channels"],
                           num_block=config["blocks"],
                           num_grow_ch=config["growth"],
                           num_in_ch=config.get("num_in_ch", 3),
                           seed=seed), False
