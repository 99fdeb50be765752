"""Training checkpoints (the port of ``s2sr_tpu/training/checkpoint.py``,
in a format of its own: the JAX package writes orbax checkpoints).

One directory per step, ``<directory>/<step>/``, written under a
temporary name and renamed into place, holding

- ``params.npz``: the params in the JAX ``.npz`` layout (``/``-joined
  keys, HWIO kernels; ``models/weights.py::load_npz_tree`` reads it);
- ``opt_state.npz``: Adam's ``count``, ``mu/<key>`` and ``nu/<key>``, and
  where present ``schedule_count`` and ``ema/<key>``;
- ``meta.json``: the step and which optional parts the state has.

:meth:`CheckpointManager.restore` raises ``ValueError`` when the template
differs from the checkpoint (keys, shapes, schedule or EMA), as
``train.py::restore_flexible`` expects.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.weights import (
    _flatten,
    _unflatten,
    tree_flatten,
    tree_to_numpy,
    tree_unflatten,
)

FORMAT = "s2sr_tpu_torch.checkpoint/1"


def _flat_np(tree) -> dict:
    return _flatten(tree_to_numpy(tree))


def _opt_flat(opt_state) -> dict:
    flat = {"count": opt_state.count.detach().cpu().numpy()}
    for part in ("mu", "nu", "ema"):
        tree = getattr(opt_state, part)
        if tree is not None:
            flat.update({f"{part}/{k}": v for k, v in _flat_np(tree).items()})
    if opt_state.schedule_count is not None:
        flat["schedule_count"] = opt_state.schedule_count.detach().cpu().numpy()
    return flat


def _like(flat: dict, template: dict, what: str) -> None:
    """Raise ``ValueError`` unless ``flat`` has the template's keys and
    shapes."""
    if set(flat) != set(template):
        missing = sorted(set(template) - set(flat))[:3]
        extra = sorted(set(flat) - set(template))[:3]
        raise ValueError(f"checkpoint {what} differs from the template: "
                         f"missing {missing}, unexpected {extra}")
    for k, v in template.items():
        if tuple(flat[k].shape) != tuple(np.shape(v)):
            raise ValueError(f"checkpoint {what} {k} has shape "
                             f"{flat[k].shape}, template {np.shape(v)}")


def _restore_tree(flat: dict, like, prefix: str = ""):
    """The template tree ``like`` with each leaf replaced by the array of
    ``flat`` under its key, as a tensor of the leaf's dtype and device."""
    keyed = _flatten(tree_to_numpy(like))
    tree = _unflatten({k: flat[prefix + k] for k in keyed})
    src, _ = tree_flatten(tree)
    dst, struct = tree_flatten(like)
    return tree_unflatten(struct, [
        torch.as_tensor(s).to(device=d.device, dtype=d.dtype)
        for s, d in zip(src, dst)])


class CheckpointManager:
    """save / restore (params, opt_state, step) with a keep policy."""

    def __init__(self, directory: Path | str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)

    def all_steps(self) -> list:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / "meta.json").exists())

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Any, opt_state: Any) -> bool:
        """Write step ``step`` unless the interval skips it or a step at
        or after it exists; → whether it was written. Beyond
        ``max_to_keep`` the oldest steps are deleted."""
        latest = self.latest_step
        if latest is not None and (step <= latest
                                   or step % self.save_interval_steps):
            return False
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = self.directory / f".tmp-{step}-{uuid.uuid4().hex}"
        tmp.mkdir()
        try:
            np.savez(tmp / "params.npz", **_flat_np(params))
            np.savez(tmp / "opt_state.npz", **_opt_flat(opt_state))
            (tmp / "meta.json").write_text(json.dumps({
                "format": FORMAT, "step": int(step),
                "schedule": opt_state.schedule_count is not None,
                "ema": opt_state.ema is not None}))
            os.replace(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return True

    def restore(self, params_like: Any, opt_state_like: Any,
                step: Optional[int] = None) -> Tuple[Any, Any, int]:
        """Restore the latest (or a given) step onto the templates' dtypes
        and devices; ``FileNotFoundError`` without a checkpoint,
        ``ValueError`` when a template differs from it."""
        from .train import OptState

        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self.directory / str(step)
        with np.load(d / "params.npz") as z:
            pflat = {k: z[k] for k in z.files}
        with np.load(d / "opt_state.npz") as z:
            oflat = {k: z[k] for k in z.files}
        _like(pflat, _flat_np(params_like), "params")
        _like(oflat, _opt_flat(opt_state_like), "optimizer state")
        params = _restore_tree(pflat, params_like)
        o = opt_state_like

        def scalar(key, like):
            return torch.as_tensor(oflat[key]).to(like.device, like.dtype)

        opt = OptState(
            count=scalar("count", o.count),
            mu=_restore_tree(oflat, o.mu, "mu/"),
            nu=_restore_tree(oflat, o.nu, "nu/"),
            schedule_count=(None if o.schedule_count is None
                            else scalar("schedule_count", o.schedule_count)),
            ema=None if o.ema is None else _restore_tree(oflat, o.ema, "ema/"))
        return params, opt, step

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
