"""TensorFlow GraphDef (.pb) weight extraction — no TensorFlow needed.

The port's own copy of ``s2sr_tpu/models/pb_reader.py`` (numpy only; it
imports nothing of the JAX package). The reference's EDSR/ESPCN/LapSRN
models ship as frozen TF GraphDefs consumed by ``cv2.dnn_superres``
(``server/app/super_resolution.py:61-89``). This module walks the
protobuf wire format directly (GraphDef → NodeDef → AttrValue →
TensorProto), pulls every Const tensor out, then maps them onto the
classic models' parameter trees by shape signature. The trees are the
JAX package's (numpy arrays, HWIO kernels, EDSR's blocks stacked on a
leading axis);
:func:`s2sr_tpu_torch.models.weights.params_from_jax_classic` turns one
into the port's state dict.

Wire-format subset handled: varint, 64-bit, length-delimited fields;
TensorProto payloads via ``tensor_content`` bytes or repeated
``float_val``/``int_val``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# TF DataType enum values we support
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) for a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:          # varint
            value, pos = _read_varint(buf, pos)
            yield field, wire, value
        elif wire == 1:        # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:        # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + length]
            pos += length
        elif wire == 5:        # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _signed64(v: int) -> int:
    """Varint → signed 64-bit (protobuf two's-complement encoding)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf: bytes) -> Optional[np.ndarray]:
    """TensorProto → ndarray (None if dtype unsupported)."""
    dtype = None
    shape: List[int] = []
    content = b""
    float_vals: List[float] = []
    int_vals: List[int] = []
    for field, wire, value in _walk(buf):
        if field == 1 and wire == 0:                   # dtype
            dtype = _DTYPES.get(value)
            if dtype is None:
                return None
        elif field == 2 and wire == 2:                 # tensor_shape
            for f2, w2, v2 in _walk(value):
                if f2 == 2 and w2 == 2:                # dim
                    for f3, w3, v3 in _walk(v2):
                        if f3 == 1 and w3 == 0:        # size
                            shape.append(v3)
        elif field == 4 and wire == 2:                 # tensor_content
            content = value
        elif field == 5:                               # float_val
            if wire == 5:
                float_vals.append(struct.unpack("<f", value)[0])
            elif wire == 2:                            # packed
                float_vals.extend(np.frombuffer(value, "<f4").tolist())
        elif field == 3 and wire == 0:                 # version? skip
            pass
        elif field == 6:                               # double_val
            if wire == 1:
                float_vals.append(struct.unpack("<d", value)[0])
            elif wire == 2:                            # packed doubles
                float_vals.extend(np.frombuffer(value, "<f8").tolist())
        elif field in (7, 9):                          # int_val / int64_val
            # proto3 packs repeated varints (wire 2) by default; negative
            # ints arrive as 64-bit two's-complement varints either way
            if wire == 0:
                int_vals.append(_signed64(value))
            elif wire == 2:                            # packed varints
                p = 0
                while p < len(value):
                    v2, p = _read_varint(value, p)
                    int_vals.append(_signed64(v2))
    if dtype is None:
        return None
    if content:
        arr = np.frombuffer(content, dtype=np.dtype(dtype).newbyteorder("<"))
    elif float_vals:
        arr = np.asarray(float_vals, dtype)
    elif int_vals:
        arr = np.asarray(int_vals, dtype)
    else:
        arr = np.zeros(0, dtype)
    if shape:
        total = int(np.prod(shape))
        if arr.size == 1 and total > 1:
            arr = np.full(total, arr[0], dtype)
        arr = arr[:total].reshape(shape)
    return arr.astype(dtype)


def _parse_attr_value(buf: bytes):
    """AttrValue → python value (s/i/f/b/type/tensor/list-of-i)."""
    for field, wire, value in _walk(buf):
        if field == 2 and wire == 2:                   # s
            return value.decode("utf-8", "replace")
        if field == 3 and wire == 0:                   # i
            return value
        if field == 4 and wire == 5:                   # f
            return struct.unpack("<f", value)[0]
        if field == 5 and wire == 0:                   # b
            return bool(value)
        if field == 6 and wire == 0:                   # type
            return ("dtype", value)
        if field == 8 and wire == 2:                   # tensor
            return _parse_tensor(value)
        if field == 1 and wire == 2:                   # list
            ints = [v for f2, w2, v in _walk(value) if f2 == 3 and w2 == 0]
            return ints
    return None


def read_graphdef_nodes(path: Path | str) -> List[dict]:
    """Full NodeDef parse: ``[{name, op, inputs, attrs}, …]`` in graph
    order. ``attrs`` values are decoded AttrValues (str/int/float/bool/
    ndarray/list-of-int). Control inputs (``^name``) are dropped; tensor
    output suffixes (``name:0``) are stripped."""
    buf = Path(path).read_bytes()
    nodes: List[dict] = []
    for field, wire, node_buf in _walk(buf):
        if field != 1 or wire != 2:
            continue
        node = {"name": None, "op": None, "inputs": [], "attrs": {}}
        for f, w, v in _walk(node_buf):
            if f == 1 and w == 2:
                node["name"] = v.decode("utf-8", "replace")
            elif f == 2 and w == 2:
                node["op"] = v.decode("utf-8", "replace")
            elif f == 3 and w == 2:
                inp = v.decode("utf-8", "replace")
                if not inp.startswith("^"):
                    node["inputs"].append(inp.split(":")[0])
            elif f == 5 and w == 2:                    # attr map entry
                key = attr_buf = None
                for f2, w2, v2 in _walk(v):
                    if f2 == 1 and w2 == 2:
                        key = v2.decode("utf-8", "replace")
                    elif f2 == 2 and w2 == 2:
                        attr_buf = v2
                if key is not None and attr_buf is not None:
                    node["attrs"][key] = _parse_attr_value(attr_buf)
        if node["name"] and node["op"]:
            nodes.append(node)
    return nodes


def read_graphdef_constants(path: Path | str) -> Dict[str, np.ndarray]:
    """name → tensor for every Const node in a frozen GraphDef."""
    buf = Path(path).read_bytes()
    constants: Dict[str, np.ndarray] = {}
    for field, wire, node_buf in _walk(buf):
        if field != 1 or wire != 2:
            continue
        name = op = None
        tensor = None
        for f, w, v in _walk(node_buf):
            if f == 1 and w == 2:
                name = v.decode("utf-8", "replace")
            elif f == 2 and w == 2:
                op = v.decode("utf-8", "replace")
            elif f == 5 and w == 2:                    # attr map entry
                key = None
                attr_buf = None
                for f2, w2, v2 in _walk(v):
                    if f2 == 1 and w2 == 2:
                        key = v2.decode("utf-8", "replace")
                    elif f2 == 2 and w2 == 2:
                        attr_buf = v2
                if key == "value" and attr_buf is not None:
                    for f3, w3, v3 in _walk(attr_buf):
                        if f3 == 8 and w3 == 2:        # tensor
                            tensor = _parse_tensor(v3)
        if op == "Const" and name and tensor is not None:
            constants[name] = tensor
    return constants


def wire_ordered_convs(path: Path | str):
    """(name, kernel, bias) per Conv2D/Conv2DBackpropInput node, paired
    by ACTUAL graph edges: the kernel is the Const feeding the conv's
    filter input (through Identity), the bias is the Const of the
    BiasAdd/Add consuming the conv. Immune to Const-ordering quirks
    that can mis-pair the order+shape heuristic (e.g. bias-less
    transposed convs in multi-level LapSRN graphs). Returns None when
    the file carries no op wiring (const-only test graphs)."""
    nodes = read_graphdef_nodes(path)
    by_name = {n["name"]: n for n in nodes}
    consts = {n["name"]: n["attrs"].get("value") for n in nodes
              if n["op"] == "Const"}

    def resolve_const(name):
        seen = set()
        while name in by_name and name not in seen:
            seen.add(name)
            node = by_name[name]
            if node["op"] == "Const":
                return consts.get(name)
            if node["op"] in ("Identity", "StopGradient") and node["inputs"]:
                name = node["inputs"][0]
                continue
            break
        return None

    conv_ops = ("Conv2D", "Conv2DBackpropInput")
    convs = []
    consumers: Dict[str, list] = {}
    for n in nodes:
        for i in n["inputs"]:
            consumers.setdefault(i, []).append(n)
    found_ops = False
    for n in nodes:
        if n["op"] not in conv_ops:
            continue
        found_ops = True
        filt_idx = 1
        kernel = resolve_const(n["inputs"][filt_idx])
        if kernel is None or getattr(kernel, "ndim", 0) != 4:
            continue
        bias = None
        for c in consumers.get(n["name"], []):
            if c["op"] in ("BiasAdd", "Add", "AddV2"):
                for ci in c["inputs"]:
                    if ci != n["name"]:
                        b = resolve_const(ci)
                        if b is not None and getattr(b, "ndim", 0) == 1:
                            bias = b
                break
        convs.append((n["name"], np.asarray(kernel),
                      None if bias is None else np.asarray(bias)))
    return convs if found_ops else None


def _ordered_convs(constants: Dict[str, np.ndarray]):
    """Pair each 4-D kernel with its following 1-D bias (matching size),
    preserving GraphDef construction order — frozen TF graphs list Const
    nodes in forward-pass order."""
    items = list(constants.items())
    convs = []
    used = set()
    for i, (name, t) in enumerate(items):
        if t.ndim != 4:
            continue
        bias = None
        for j in range(i + 1, len(items)):
            bn, bt = items[j]
            if bt.ndim == 4:
                break
            if bt.ndim == 1 and bt.shape[0] == t.shape[3] and bn not in used:
                bias = bt
                used.add(bn)
                break
        convs.append((name, t, bias))
    return convs


def _jconv(kernel: np.ndarray, bias) -> dict:
    if bias is None:
        bias = np.zeros(kernel.shape[3], np.float32)
    return {"kernel": np.asarray(kernel), "bias": np.asarray(bias)}


def _shape_audit(convs) -> str:
    return ", ".join(f"{n}:{t.shape}" for n, t, _ in convs)


def convert_edsr_pb(path: Path | str, scale: int) -> tuple:
    """Frozen EDSR .pb (Saafke/EDSR_Tensorflow graphs consumed by
    ``cv2.dnn_superres``, ref ``super_resolution.py:22-41``) → our param
    tree + inferred config.

    Mapping is structural (order + shape signature), so it is robust to
    node renames: head = first (3,3,3,F); 2B+1 kernels of (3,3,F,F) are
    the B residual blocks plus the post-body conv; (3,3,F,F·f²) kernels
    are pixel-shuffle upsamples; (3,3,F,3) is the tail. A graph that does
    not match raises with a full shape inventory for diagnosis.

    Returns ``(params, config)`` with ``config = {"channels": F,
    "blocks": B, "mean": optional (3,) mean}``.
    """
    constants = read_graphdef_constants(path)
    wired = wire_ordered_convs(path)
    convs = wired if wired is not None else _ordered_convs(constants)
    if not convs:
        raise ValueError(f"no conv kernels in {path}")

    head = next(((n, t, b) for n, t, b in convs if t.shape[2] == 3
                 and t.shape[3] > 3), None)
    if head is None:
        raise ValueError(f"no head conv (3→F) in {path}: {_shape_audit(convs)}")
    feat = head[1].shape[3]

    ff = [(n, t, b) for n, t, b in convs if t.shape[2] == feat
          and t.shape[3] == feat]
    ups = [(n, t, b) for n, t, b in convs if t.shape[2] == feat
           and t.shape[3] in (feat * 4, feat * 9)]
    tail = [(n, t, b) for n, t, b in convs if t.shape[2] == feat
            and t.shape[3] == 3]
    if len(ff) % 2 != 1 or not tail:
        raise ValueError(
            f"unexpected EDSR structure in {path} (feat={feat}, "
            f"{len(ff)} FxF convs, {len(ups)} upsample, {len(tail)} tail): "
            f"{_shape_audit(convs)}")
    blocks = (len(ff) - 1) // 2

    body = [{"conv1": _jconv(ff[2 * i][1], ff[2 * i][2]),
             "conv2": _jconv(ff[2 * i + 1][1], ff[2 * i + 1][2])}
            for i in range(blocks)]
    params = {
        "head": _jconv(head[1], head[2]),
        "body": {c: {leaf: np.stack([b[c][leaf] for b in body])
                     for leaf in ("kernel", "bias")}
                 for c in ("conv1", "conv2")},
        "body_conv": _jconv(ff[-1][1], ff[-1][2]),
        "upsample": [_jconv(t, b) for _, t, b in ups],
        "tail": _jconv(tail[-1][1], tail[-1][2]),
    }
    config = {"channels": feat, "blocks": blocks}
    if wired is not None:
        # wire-accurate: the mean is the (3,) const feeding a Sub/Add
        # node that is NOT a conv bias-add — an Add directly consuming
        # a conv output is that conv's bias (already wired into params
        # by wire_ordered_convs) and must not be misread as the DIV2K
        # mean, or it would be applied twice
        nodes = read_graphdef_nodes(path)
        by_name = {n["name"]: n for n in nodes}
        cvals = {n["name"]: n["attrs"].get("value") for n in nodes
                 if n["op"] == "Const"}
        conv_ops = ("Conv2D", "Conv2DBackpropInput")

        def consumes_conv(node):
            return any(by_name.get(i, {}).get("op") in conv_ops
                       for i in node["inputs"])

        for n in nodes:
            if n["op"] in ("Sub", "Add", "AddV2") and not consumes_conv(n):
                for i in n["inputs"]:
                    t = cvals.get(i)
                    if t is not None and t.ndim == 1 and t.shape[0] == 3:
                        config["mean"] = np.asarray(t, np.float32)
                        break
                if "mean" in config:
                    break
    else:
        # const-only fallback: a stray (3,) const that is not a conv bias
        bias_arrays = {id(b) for _, _, b in convs if b is not None}
        for name, t in constants.items():
            if t.ndim == 1 and t.shape[0] == 3 and id(t) not in bias_arrays:
                config["mean"] = np.asarray(t, np.float32)
                break
    return params, config


def convert_lapsrn_pb(path: Path | str, scale: int) -> dict:
    """Frozen LapSRN .pb (fannymonori/TF-LAPSRN graphs, ref
    ``super_resolution.py:44-58``) → our param tree.

    Structure: head (3,3,C,F) with C ∈ {1 (released luma graphs), 3};
    per ×2 level, embedding convs (3,3,F,F), a feature transposed-conv
    (4,4,F,F), a residual conv (3,3,F,C) and an image transposed-conv
    (4,4,C,C). Transposed-conv kernels are kept RAW — TF's
    ``Conv2DBackpropInput`` filter layout (HWIO of the forward conv),
    which ``params_from_jax_classic`` permutes for
    :func:`s2sr_tpu_torch.models.classic.transposed_conv_x2`. Levels
    with shared weights (the paper's parameter sharing, possible in x8
    graphs) are replicated.
    """
    constants = read_graphdef_constants(path)
    wired = wire_ordered_convs(path)
    convs = wired if wired is not None else _ordered_convs(constants)
    head = next(((n, t, b) for n, t, b in convs
                 if t.shape[:2] == (3, 3) and t.shape[2] in (1, 3)
                 and t.shape[3] > 3), None)
    if head is None:
        raise ValueError(f"no head conv in {path}: {_shape_audit(convs)}")
    feat = head[1].shape[3]
    nch = head[1].shape[2]
    import math as _math

    levels_needed = int(_math.log2(scale))
    rest = [c for c in convs if c[0] != head[0]]
    groups = []
    cur = {"embed": [], "up_feat": None, "res": None, "up_img": None}
    for name, t, b in rest:
        kh = t.shape[0]
        if kh == 3 and t.shape[2] == feat and t.shape[3] == feat:
            cur["embed"].append(_jconv(t, b))
        elif t.shape[2] == feat and t.shape[3] == feat and kh >= 4:
            cur["up_feat"] = np.asarray(t)
        elif kh == 3 and t.shape[2] == feat and t.shape[3] == nch:
            cur["res"] = _jconv(t, b)
        elif t.shape[2] == nch and t.shape[3] == nch and kh >= 4:
            cur["up_img"] = np.asarray(t)
            groups.append(cur)
            cur = {"embed": [], "up_feat": None, "res": None,
                   "up_img": None}
    if not groups or any(g["up_feat"] is None or g["res"] is None
                         for g in groups):
        raise ValueError(
            f"unexpected LapSRN structure in {path}: {_shape_audit(convs)}")
    while len(groups) < levels_needed:   # weight sharing across levels
        groups.append(groups[-1])
    return {"head": _jconv(head[1], head[2]),
            "levels": groups[:levels_needed]}


def convert_espcn_pb(path: Path | str, scale: int) -> dict:
    """Frozen ESPCN .pb → our param tree, matched by kernel shapes.

    ESPCN's three convs are unambiguous by shape: 5×5×C→64, 3×3×64→32,
    3×3×32→(C·s²), with C = 1 in the released luma graphs. TF kernels
    are already HWIO — no transpose needed.
    """
    constants = read_graphdef_constants(path)
    kernels = sorted(
        [t for t in constants.values() if t.ndim == 4],
        key=lambda t: -t.shape[0])
    biases = [t for t in constants.values() if t.ndim == 1]
    if len(kernels) < 3:
        raise ValueError(f"expected ≥3 conv kernels in {path}, "
                         f"found {len(kernels)}")

    def bias_for(kernel):
        for b in biases:
            if b.shape[0] == kernel.shape[3]:
                return b
        return np.zeros(kernel.shape[3], np.float32)

    names = ("conv1", "conv2", "conv3")
    params = {}
    for name, kernel in zip(names, kernels[:3]):
        params[name] = {"kernel": np.asarray(kernel),
                        "bias": np.asarray(bias_for(kernel))}
    return params
