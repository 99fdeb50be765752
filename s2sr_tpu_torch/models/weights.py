"""RRDBNet, SwinIR and classic-model weights for the port: ``.pth`` and
flat-key ``.npz`` loading and writing, JAX param trees, and the
deterministic random inits.

The port's modules carry the released checkpoints' parameter names and
OIHW layout, so a ``.pth`` state dict needs only unwrapping. The JAX
package's trees (HWIO kernels, Linear weights (in, out), the RRDB stack
on a leading ``body`` axis, SwinIR's ``layers``/``blocks`` lists) and
its ``.npz`` files (the same tree flattened with ``/`` keys) map over
with :func:`params_from_jax`, :func:`params_from_jax_swinir` and
:func:`params_from_jax_classic`; :func:`convert_checkpoint` writes a
released RRDBNet ``.pth`` as that ``.npz`` (:func:`save_params`), so
either package loads what the other wrote. :func:`download_weights`
fetches a released RRDBNet ``.pth`` from the registry's URL when
``Settings.offline`` is False (:func:`resolve_params`), and
:func:`train_state_from_jax` carries a JAX training state across.
"""

from __future__ import annotations

import logging
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


def rrdbnet_tree(sd: Mapping[str, Any]) -> dict:
    """A (possibly wrapped) released RRDBNet state dict → the JAX
    package's param tree of numpy arrays (HWIO kernels, the RRDB stack on
    a leading ``body`` axis): ``s2sr_tpu.models.weights.
    convert_rrdbnet_state_dict`` without JAX."""
    if "params_ema" in sd:
        sd = sd["params_ema"]
    elif "params" in sd:
        sd = sd["params"]

    def arr(v) -> np.ndarray:
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    def conv(prefix):
        return {"kernel": np.transpose(arr(sd[f"{prefix}.weight"]),
                                       (2, 3, 1, 0)),
                "bias": arr(sd[f"{prefix}.bias"])}

    num_block = 1 + max(int(k.split(".")[1]) for k in sd
                        if k.startswith("body."))
    body = {f"rdb{j}": {f"conv{k}": {
        leaf: np.stack([conv(f"body.{i}.rdb{j}.conv{k}")[leaf]
                        for i in range(num_block)])
        for leaf in ("kernel", "bias")} for k in (1, 2, 3, 4, 5)}
        for j in (1, 2, 3)}
    tree = {"body": body}
    for name in _TOP_CONVS:
        if f"{name}.weight" in sd:
            tree[name] = conv(name)
    return tree


def convert_checkpoint(pth_path: Path | str, out_path: Path | str) -> Path:
    """A released RRDBNet ``.pth`` → the JAX package's flat ``.npz``
    (the same keys and values as ``s2sr_tpu.models.weights.
    convert_checkpoint``; either package loads it)."""
    return save_params(rrdbnet_tree(load_torch_checkpoint(pth_path)),
                       out_path)


# --- flat npz (the JAX package's layout) -------------------------------

def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested tree → ``/``-joined keys; lists flatten with index keys."""
    out: Dict[str, np.ndarray] = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    for key, value in items:
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, (dict, list, tuple)):
            out.update(_flatten(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def save_params(tree, path: Path | str) -> Path:
    """A JAX-layout param tree of arrays → a flat ``.npz``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **_flatten(tree))
    return path


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


# --- param trees (training) --------------------------------------------

def tree_flatten(tree) -> tuple:
    """A nested dict/list tree → (leaves in key order, structure)."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        for k, v in tree.items():
            lv, d = tree_flatten(v)
            leaves += lv
            defs.append((k, d))
        return leaves, ("dict", defs)
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for v in tree:
            lv, d = tree_flatten(v)
            leaves += lv
            defs.append(d)
        return leaves, ("list", defs)
    return [tree], None


def tree_unflatten(struct, leaves) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, defs = d
        if kind == "dict":
            return {k: build(sub) for k, sub in defs}
        return [build(sub) for sub in defs]

    return build(struct)


def tree_map(fn, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of same-structured
    ``rest``), keeping the structure."""
    leaves, struct = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(struct, [fn(*xs) for xs in zip(leaves, *others)])


def tree_to_torch(tree, device="cpu") -> Any:
    """A tree of arrays → float32 tensors on ``device`` (copies)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                           device=device), tree)


def tree_to_numpy(tree) -> Any:
    """A tree of tensors → numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def train_state_from_jax(params, opt_state, device="cpu") -> tuple:
    """A JAX training state, ``(params, optax state)`` with numpy leaves,
    → the port's ``(params, OptState)`` on ``device``: the Adam moments
    and count (``ScaleByAdamState``), the schedule count
    (``ScaleByScheduleState``) and the weight EMA (``EmaState``) found
    by kind anywhere in the state's nested tuples."""
    from ..training.train import OptState

    found: dict = {}

    def walk(s):
        fields = getattr(s, "_fields", None)
        if fields is not None and {"count", "mu", "nu"} <= set(fields):
            found["adam"] = s
        elif fields is not None and tuple(fields) == ("count",):
            found["schedule"] = s
        elif fields is not None and tuple(fields) == ("ema",):
            found["ema"] = s
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)

    walk(opt_state)
    if "adam" not in found:
        raise ValueError("no Adam state (count, mu, nu) in the JAX state")
    adam = found["adam"]

    def count(c):
        return torch.tensor(int(np.asarray(c)), dtype=torch.int32,
                            device=device)

    return tree_to_torch(params, device), OptState(
        count=count(adam.count), mu=tree_to_torch(adam.mu, device),
        nu=tree_to_torch(adam.nu, device),
        schedule_count=(count(found["schedule"].count)
                        if "schedule" in found else None),
        ema=(tree_to_torch(found["ema"].ema, device)
             if "ema" in found else None))


# --- classic models (EDSR, ESPCN, LapSRN) ------------------------------

def params_from_jax_classic(tree: Mapping[str, Any], family: str,
                            mean=None) -> StateDict:
    """A JAX ``classic.py`` param tree of numpy arrays → the state dict of
    :mod:`s2sr_tpu_torch.models.classic`'s module: HWIO → OIHW, EDSR's
    stacked ``body`` split into blocks and its ``mean`` buffer (``mean``,
    else the tree's, else DIV2K's: JAX keeps it on the instance), LapSRN's
    ``up_feat`` / ``up_img`` as ``conv_transpose2d`` weights (HWIO
    permuted (3, 2, 0, 1), the layout the forward conv's OIHW has)."""
    sd: StateDict = {}

    def conv(name, p):
        sd[f"{name}.weight"] = _hwio_to_oihw(p["kernel"])
        sd[f"{name}.bias"] = _np(p["bias"])

    if family == "edsr":
        from .classic import DIV2K_MEAN

        conv("head", tree["head"])
        body = tree["body"]
        for i in range(np.asarray(body["conv1"]["kernel"]).shape[0]):
            for c in ("conv1", "conv2"):
                conv(f"body.{i}.{c}", {k: np.asarray(v)[i]
                                       for k, v in body[c].items()})
        conv("body_conv", tree["body_conv"])
        for i, up in enumerate(tree["upsample"]):
            conv(f"upsample.{i}", up)
        conv("tail", tree["tail"])
        if mean is None:
            mean = tree.get("mean", DIV2K_MEAN)
        sd["mean"] = _np(mean)
    elif family == "espcn":
        for name in ("conv1", "conv2", "conv3"):
            conv(name, tree[name])
    elif family == "lapsrn":
        conv("head", tree["head"])
        for li, level in enumerate(tree["levels"]):
            for ei, embed in enumerate(level["embed"]):
                conv(f"levels.{li}.embed.{ei}", embed)
            conv(f"levels.{li}.res", level["res"])
            for name in ("up_feat", "up_img"):
                sd[f"levels.{li}.{name}"] = _hwio_to_oihw(level[name])
    else:
        raise ValueError(f"not a classic model family: {family}")
    return sd


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


def swinir_tree(sd: Mapping[str, Any], depths) -> dict:
    """The port's SwinIR state dict → the JAX package's param tree of
    numpy arrays (HWIO kernels, Linear weights (in, out)): the inverse of
    :func:`params_from_jax_swinir`."""
    def arr(name):
        v = sd[name]
        return (v.detach().cpu().float().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32))

    def conv(name):
        return {"kernel": np.ascontiguousarray(
            np.transpose(arr(f"{name}.weight"), (2, 3, 1, 0))),
            "bias": arr(f"{name}.bias")}

    def lin(name):
        return {"weight": np.ascontiguousarray(arr(f"{name}.weight").T),
                "bias": arr(f"{name}.bias")}

    def norm(name):
        return {"weight": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}

    layers = []
    for li, depth in enumerate(depths):
        blocks = []
        for bi in range(depth):
            pre = f"layers.{li}.residual_group.blocks.{bi}"
            blocks.append({
                "norm1": norm(f"{pre}.norm1"),
                "attn": {"qkv": lin(f"{pre}.attn.qkv"),
                         "proj": lin(f"{pre}.attn.proj"),
                         "relative_position_bias_table": arr(
                             f"{pre}.attn.relative_position_bias_table")},
                "norm2": norm(f"{pre}.norm2"),
                "mlp": {"fc1": lin(f"{pre}.mlp.fc1"),
                        "fc2": lin(f"{pre}.mlp.fc2")}})
        layers.append({"blocks": blocks, "conv": conv(f"layers.{li}.conv")})
    ups = []
    while f"upsample.{2 * len(ups)}.weight" in sd:
        ups.append(conv(f"upsample.{2 * len(ups)}"))
    return {"conv_first": conv("conv_first"),
            "norm_embed": norm("patch_embed.norm"), "layers": layers,
            "norm": norm("norm"), "conv_after_body": conv("conv_after_body"),
            "conv_before_upsample": conv("conv_before_upsample.0"),
            "conv_last": conv("conv_last"), "upsample": ups}


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


def download_weights(model_name: str, dest_dir: Path | str,
                     url: str | None = None,
                     timeout: float = 120.0) -> Path:
    """Download the released checkpoint on first use (cache keyed by the
    model's name; fetch the registry's URL when absent) → the cached
    ``.pth`` path. Written to ``.pth.partial`` and renamed, so a reader
    never sees a torn file. Raises on a network failure: callers gate on
    ``Settings.offline`` and fall back to random init loudly."""
    from .registry import get_model_config

    if url is None:
        url = get_model_config(model_name).get("url")
    if not url:
        raise ValueError(f"no release URL registered for {model_name}")
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / f"{model_name}.pth"
    if dest.exists():
        return dest

    import urllib.request

    tmp = dest.with_suffix(".pth.partial")
    req = urllib.request.Request(url, headers={"User-Agent": "s2sr-tpu/2.0"})
    with urllib.request.urlopen(req, timeout=timeout) as resp, \
            open(tmp, "wb") as out:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            out.write(chunk)
    tmp.rename(dest)
    return dest


def resolve_params(model_name: str, weights_dir: Path | str,
                   seed: int = 0,
                   allow_download: bool | None = None
                   ) -> tuple[StateDict, bool]:
    """The weights of ``model_name`` → ``(state_dict, pretrained)``.

    RRDBNet: a converted ``.npz`` if present; else a released ``.pth``,
    downloaded first from the registry's URL when it is absent and
    downloads are allowed (``allow_download=None`` reads
    ``Settings.offline``), converted to the ``.npz`` beside it and loaded
    from there; else (a failed download is logged as an error) the
    deterministic random init. SwinIR: the ``.npz``, else the ``.pth``,
    else the random init; it never downloads."""
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
    if not pth.exists():
        if allow_download is None:
            from ..config import get_settings

            allow_download = not get_settings().offline
        if allow_download and config.get("url"):
            try:
                download_weights(model_name, weights_dir)
            except Exception as exc:  # serve on, loudly
                logging.getLogger("s2sr_tpu_torch.weights").error(
                    "weight download failed for %s: %s — falling back to "
                    "random init", model_name, exc)
    if pth.exists():
        convert_checkpoint(pth, npz)
        return load_params(npz), True
    return init_state_dict(num_feat=config["channels"],
                           num_block=config["blocks"],
                           num_grow_ch=config["growth"],
                           num_in_ch=config.get("num_in_ch", 3),
                           seed=seed), False
