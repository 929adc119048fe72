"""Checkpoint / resume (port of ``tgm_tpu/train/checkpoint.py``).

All training state (a ``TGNCarry``: weights, optimizer state, TGN memory,
recency buffers and the negatives' generator) is one tree, saved and
restored whole. A checkpoint is a directory holding ``checkpoint.pt``,
written with ``torch.save`` and read with ``torch.load(weights_only=True)``.

The tree may nest tensors, numbers, strings, ``None``, dicts, lists, tuples
and NamedTuples, ``nn.Module``\\ s, optimizers and ``torch.Generator``\\ s. It
is written as plain data: tensors on the CPU, a module's or an optimizer's
``state_dict``, a generator's ``get_state()``, a NamedTuple as a dict of its
fields. ``restore_checkpoint(path, like)`` puts the data back into
``like``'s structure: tensors go to ``like``'s device and dtype; modules,
optimizers and generators are loaded in place and returned; NamedTuples are
rebuilt. Without ``like`` it returns the plain tree.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch
from torch import nn

from ..exceptions import CheckpointError

FILE_NAME = "checkpoint.pt"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _plain(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (nn.Module, torch.optim.Optimizer)):
        return _plain(x.state_dict())
    if isinstance(x, torch.Generator):
        return x.get_state()
    if _is_namedtuple(x):
        return {k: _plain(v) for k, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return type(x)((k, _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _into(plain: Any, like: Any, where: str) -> Any:
    """``plain`` in ``like``'s structure; ``where`` names the node in errors."""
    if isinstance(like, torch.Tensor):
        if not isinstance(plain, torch.Tensor) or plain.shape != like.shape:
            got = tuple(plain.shape) if isinstance(plain, torch.Tensor) else type(plain).__name__
            raise CheckpointError(f"{where}: saved {got}, expected {tuple(like.shape)}")
        return plain.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (nn.Module, torch.optim.Optimizer, torch.Generator)):
        try:
            if isinstance(like, torch.Generator):
                like.set_state(plain)
            else:
                like.load_state_dict(plain)
        except (RuntimeError, KeyError, ValueError, TypeError) as e:
            raise CheckpointError(f"{where}: {e}") from e
        return like
    if _is_namedtuple(like) or isinstance(like, dict):
        items = like._asdict() if _is_namedtuple(like) else like
        if not isinstance(plain, dict):
            raise CheckpointError(f"{where}: saved a {type(plain).__name__}, expected a mapping")
        if set(plain) != set(items):
            raise CheckpointError(f"{where}: saved keys {sorted(map(str, plain))}, expected "
                                  f"{sorted(map(str, items))}")
        values = [_into(plain[k], v, f"{where}.{k}") for k, v in items.items()]
        return type(like)(*values) if _is_namedtuple(like) else type(like)(zip(items, values))
    if isinstance(like, (list, tuple)):
        if not isinstance(plain, (list, tuple)) or len(plain) != len(like):
            raise CheckpointError(f"{where}: saved {plain!r:.80}, expected {len(like)} entries")
        return type(like)(_into(p, v, f"{where}[{i}]") for i, (p, v) in enumerate(zip(plain, like)))
    return plain


def save_checkpoint(path: str, state: Any, force: bool = True) -> None:
    """Write ``state`` to the directory ``path`` (created if absent).

    An existing checkpoint there is replaced when ``force``, else raises.
    The file is written whole, then renamed into place.
    """
    path = os.path.abspath(path)
    target = os.path.join(path, FILE_NAME)
    if os.path.exists(target) and not force:
        raise CheckpointError(f"checkpoint exists and force=False: {path}")
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=path)
    os.close(fd)
    try:
        torch.save(_plain(state), tmp)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """Read the tree saved in ``path``; with ``like``, in its structure
    (recommended), loading its modules, optimizers and generators in place."""
    target = os.path.join(os.path.abspath(path), FILE_NAME)
    if not os.path.exists(target):
        raise CheckpointError(f"checkpoint path does not exist: {os.path.abspath(path)}")
    plain = torch.load(target, map_location="cpu", weights_only=True)
    return plain if like is None else _into(plain, like, "state")


class CheckpointManager:
    """Rotating step-indexed checkpoints (keep the most recent ``max_to_keep``;
    ``None`` keeps all), one subdirectory per step."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, FILE_NAME)))

    def save(self, step: int, state: Any) -> None:
        save_checkpoint(os.path.join(self.directory, str(step)), state)
        if self.max_to_keep is not None:
            for old in self._steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, like: Optional[Any] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError("no checkpoints found")
        return restore_checkpoint(os.path.join(self.directory, str(step)), like)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing to release: every save has finished when it returns."""


__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint"]
