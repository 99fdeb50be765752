"""RRDBNet and SwinIR weights for the port: ``.pth`` and flat-key
``.npz`` loading, JAX param trees, and the deterministic random inits.

The port's modules carry the released checkpoints' parameter names and
OIHW layout, so a ``.pth`` state dict needs only unwrapping. The JAX
package's trees (HWIO kernels, Linear weights (in, out), the RRDB stack
on a leading ``body`` axis, SwinIR's ``layers``/``blocks`` lists) and
its ``.npz`` files (the same tree flattened with ``/`` keys) map over
with :func:`params_from_jax` and :func:`params_from_jax_swinir`. No
download happens here.
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


# --- SwinIR ------------------------------------------------------------

_SWIN_BLOCK_LINEARS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


def _swinir_names(depths, n_upsample: int) -> tuple:
    """(conv names, linear names, norm names, bias-table names) of a
    SwinIR state dict."""
    convs = ["conv_first", "conv_after_body", "conv_before_upsample.0",
             "conv_last"] + [f"upsample.{2 * i}" for i in range(n_upsample)]
    lins, norms, tables = [], ["patch_embed.norm", "norm"], []
    for li, depth in enumerate(depths):
        convs.append(f"layers.{li}.conv")
        for bi in range(depth):
            pre = f"layers.{li}.residual_group.blocks.{bi}"
            lins += [f"{pre}.{n}" for n in _SWIN_BLOCK_LINEARS]
            norms += [f"{pre}.norm1", f"{pre}.norm2"]
            tables.append(f"{pre}.attn.relative_position_bias_table")
    return convs, lins, norms, tables


def convert_swinir_state_dict(sd: Mapping[str, Any],
                              depths=(6,) * 6) -> StateDict:
    """A released SwinIR ``.pth`` state dict → the port's state dict.

    ``params`` wins over ``params_ema`` when both are present (the
    reverse of RRDBNet's preference, as the reference loader does). The
    checkpoint's buffers (``relative_position_index``, ``attn_mask``) are
    left out: the port computes both."""
    if "params" in sd:
        sd = sd["params"]
    if "params_ema" in sd:
        sd = sd["params_ema"]
    n_up = 0
    while f"upsample.{2 * n_up}.weight" in sd:
        n_up += 1
    convs, lins, norms, tables = _swinir_names(depths, n_up)
    keys = [f"{n}.{s}" for n in convs + lins + norms
            for s in ("weight", "bias")] + tables
    return {k: torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(sd[k])
                               else sd[k]).float() for k in keys}


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def params_from_jax_swinir(tree: Mapping[str, Any]) -> StateDict:
    """A JAX SwinIR param tree of numpy arrays (HWIO kernels, Linear
    weights (in, out), ``layers``/``blocks``/``upsample`` lists) → the
    port's state dict. With :func:`load_npz_tree` it loads a JAX-layout
    SwinIR ``.npz``."""
    sd: StateDict = {}

    def conv(name, p):
        sd[f"{name}.weight"] = _hwio_to_oihw(p["kernel"])
        sd[f"{name}.bias"] = _np(p["bias"])

    def lin(name, p):
        sd[f"{name}.weight"] = _np(np.asarray(p["weight"]).T)
        sd[f"{name}.bias"] = _np(p["bias"])

    def norm(name, p):
        sd[f"{name}.weight"] = _np(p["weight"])
        sd[f"{name}.bias"] = _np(p["bias"])

    conv("conv_first", tree["conv_first"])
    norm("patch_embed.norm", tree["norm_embed"])
    for li, layer in enumerate(tree["layers"]):
        for bi, blk in enumerate(layer["blocks"]):
            pre = f"layers.{li}.residual_group.blocks.{bi}"
            norm(f"{pre}.norm1", blk["norm1"])
            lin(f"{pre}.attn.qkv", blk["attn"]["qkv"])
            lin(f"{pre}.attn.proj", blk["attn"]["proj"])
            sd[f"{pre}.attn.relative_position_bias_table"] = _np(
                blk["attn"]["relative_position_bias_table"])
            norm(f"{pre}.norm2", blk["norm2"])
            lin(f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
            lin(f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        conv(f"layers.{li}.conv", layer["conv"])
    norm("norm", tree["norm"])
    conv("conv_after_body", tree["conv_after_body"])
    conv("conv_before_upsample.0", tree["conv_before_upsample"])
    for i, up in enumerate(tree["upsample"]):
        conv(f"upsample.{2 * i}", up)
    conv("conv_last", tree["conv_last"])
    return sd


def _trunc_normal(shape, g: torch.Generator, std: float) -> torch.Tensor:
    """Normal(0, std) truncated to ±2 std by redrawing (jax.random.
    truncated_normal(-2, 2) · std)."""
    t = torch.randn(shape, generator=g)
    while True:
        bad = t.abs() > 2
        if not bad.any():
            return t * std
        t[bad] = torch.randn(int(bad.sum()), generator=g)


def init_swinir_state_dict(scale: int = 4, embed_dim: int = 180,
                           depths=(6,) * 6, num_heads=(6,) * 6,
                           window_size: int = 8, mlp_ratio: float = 2.0,
                           num_feat: int = 64, seed: int = 0) -> StateDict:
    """Deterministic init with the shapes and distributions of JAX
    ``SwinIR.init`` (Linear: truncated normal, std 0.02, zero bias; bias
    tables likewise; convs: normal · sqrt(2/fan_in), zero bias; norms:
    ones and zeros) from a ``torch.Generator`` seeded ``seed``. Its
    numbers differ from the JAX package's."""
    g = torch.Generator().manual_seed(seed)
    dim, hidden = embed_dim, int(embed_dim * mlp_ratio)
    sd: StateDict = {}

    def conv(name, cin, cout):
        sd[f"{name}.weight"] = (torch.randn(cout, cin, 3, 3, generator=g)
                                * math.sqrt(2.0 / (9 * cin)))
        sd[f"{name}.bias"] = torch.zeros(cout)

    def lin(name, cin, cout):
        sd[f"{name}.weight"] = _trunc_normal((cout, cin), g, 0.02)
        sd[f"{name}.bias"] = torch.zeros(cout)

    def norm(name, c):
        sd[f"{name}.weight"] = torch.ones(c)
        sd[f"{name}.bias"] = torch.zeros(c)

    conv("conv_first", 3, dim)
    norm("patch_embed.norm", dim)
    for li, (depth, heads) in enumerate(zip(depths, num_heads)):
        for bi in range(depth):
            pre = f"layers.{li}.residual_group.blocks.{bi}"
            norm(f"{pre}.norm1", dim)
            lin(f"{pre}.attn.qkv", dim, 3 * dim)
            lin(f"{pre}.attn.proj", dim, dim)
            sd[f"{pre}.attn.relative_position_bias_table"] = _trunc_normal(
                ((2 * window_size - 1) ** 2, heads), g, 0.02)
            norm(f"{pre}.norm2", dim)
            lin(f"{pre}.mlp.fc1", dim, hidden)
            lin(f"{pre}.mlp.fc2", hidden, dim)
        conv(f"layers.{li}.conv", dim, dim)
    norm("norm", dim)
    conv("conv_after_body", dim, dim)
    conv("conv_before_upsample.0", dim, num_feat)
    s, i = scale, 0
    while s > 1:
        factor = 2 if s % 2 == 0 else 3
        conv(f"upsample.{2 * i}", num_feat, factor * factor * num_feat)
        s, i = (s // 2 if factor == 2 else 1), i + 1
    conv("conv_last", num_feat, 3)
    return sd


def swinir_kwargs(config: Mapping[str, Any]) -> dict:
    """``SwinIR`` / :func:`init_swinir_state_dict` arguments of a
    registry entry."""
    return {"scale": config["scale"], "embed_dim": config["embed_dim"],
            "depths": tuple(config["depths"]),
            "num_heads": tuple(config["num_heads"]),
            "window_size": config["window_size"]}


def resolve_params(model_name: str, weights_dir: Path | str,
                   seed: int = 0) -> tuple[StateDict, bool]:
    """A converted ``.npz`` if present, else a released ``.pth``, else
    the deterministic random init, for either family. Returns
    ``(state_dict, pretrained)``."""
    from .registry import get_model_config

    config = get_model_config(model_name)
    weights_dir = Path(weights_dir)
    npz = weights_dir / f"{model_name}.npz"
    pth = weights_dir / f"{model_name}.pth"
    if config["family"] == "swinir":
        if npz.exists():
            return params_from_jax_swinir(load_npz_tree(npz)), True
        if pth.exists():
            return convert_swinir_state_dict(load_torch_checkpoint(pth),
                                             depths=config["depths"]), True
        return init_swinir_state_dict(**swinir_kwargs(config),
                                      seed=seed), False
    if npz.exists():
        return load_params(npz), True
    if pth.exists():
        return convert_rrdbnet_state_dict(load_torch_checkpoint(pth)), True
    return init_state_dict(num_feat=config["channels"],
                           num_block=config["blocks"],
                           num_grow_ch=config["growth"],
                           num_in_ch=config.get("num_in_ch", 3),
                           seed=seed), False
