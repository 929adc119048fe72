"""Batch container (port of ``tgm_tpu/core/batch.py``).

A plain attribute container of tensors. Edge arrays have a static width: padded
slots hold ``PADDED_NODE_ID`` / 0 and are marked invalid in ``edge_valid``
(node-feature and node-label arrays likewise, in ``node_x_valid`` and
``node_y_valid``). The JAX batch's optional fields (``FIELDS``) read None
where a batch lacks them; ``has`` tells which it holds. Hooks attach their
products as attributes (``batch.neg = ...``). ``num_node_labels``, where
set, is the batch's real label count as a host int, so a step can branch on
it without waiting for the card.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def _move(value: Any, device: torch.device) -> Any:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(_move(v, device) for v in value)
    return value


class DGBatch:
    """One batch of temporal-graph events plus hook-produced attributes."""

    # The JAX ``DGBatch``'s optional fields, None until set.
    FIELDS = ("edge_x", "edge_type", "node_x_time", "node_x_nids", "node_x", "node_x_valid",
              "node_y_time", "node_y_nids", "node_y", "node_y_valid")
    edge_x = edge_type = node_x_time = node_x_nids = node_x = node_x_valid = None
    node_y_time = node_y_nids = node_y = node_y_valid = None

    def __init__(
        self,
        edge_src: torch.Tensor,
        edge_dst: torch.Tensor,
        edge_time: torch.Tensor,
        edge_valid: Optional[torch.Tensor] = None,
        **attrs: Any,
    ) -> None:
        self.edge_src = edge_src
        self.edge_dst = edge_dst
        self.edge_time = edge_time
        self.edge_valid = edge_valid
        self.__dict__.update(attrs)

    def has(self, name: str) -> bool:
        return self.__dict__.get(name) is not None

    __contains__ = has

    def replace(self, **changes: Any) -> "DGBatch":
        out = DGBatch.__new__(DGBatch)
        out.__dict__.update(self.__dict__)
        out.__dict__.update(changes)
        return out

    @property
    def num_valid_edges(self) -> torch.Tensor:
        """The number of valid edges, a 0-dim tensor on the batch's device."""
        if self.edge_valid is None:
            return torch.tensor(self.edge_src.shape[0], device=self.edge_src.device)
        return self.edge_valid.sum()

    def to(self, device: Any) -> "DGBatch":
        out = DGBatch.__new__(DGBatch)
        out.__dict__.update({k: _move(v, torch.device(device)) for k, v in self.__dict__.items()})
        return out

    def __repr__(self) -> str:
        def describe(v: Any) -> str:
            if isinstance(v, torch.Tensor):
                return str(list(v.shape))
            if isinstance(v, (list, tuple)):
                return f"{type(v).__name__}(x{len(v)})"
            return type(v).__name__

        return "DGBatch(" + ", ".join(f"{k}={describe(v)}" for k, v in self.__dict__.items()) + ")"
