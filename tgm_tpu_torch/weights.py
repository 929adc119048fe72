"""Load the JAX package's TGN parameters into the port's modules.

``load_tgn_params`` takes the flax parameter tree ``{"mem", "enc", "dec"}``
as nested dicts of arrays (anything ``numpy.asarray`` reads), as the JAX TGN
example builds it, and copies it into a ``TGNMemory``, a
``GraphAttentionEmbeddingRowwise`` and a ``LinkPredictor``:

* Dense ``kernel (in, out)`` -> ``Linear.weight`` = kernel^T, ``bias`` -> ``bias``
  (``lin_edge`` has no bias);
* ``TorchGRUCell`` ``wi/bi/wh/bh`` -> ``weight_ih``^T / ``bias_ih`` /
  ``weight_hh``^T / ``bias_hh``;
* ``Time2Vec`` ``w (1, T)`` / ``b (T,)`` -> ``w.weight`` (T, 1) / ``w.bias``;
* the ``LinkPredictor`` MLP's ``Dense_0``, ``Dense_1``, ... -> its Linear
  layers in order.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _copy(dst: torch.Tensor, value: Any, transpose: bool = False) -> None:
    arr = np.asarray(value, dtype=np.float32)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: parameter {tuple(dst.shape)}, value {arr.shape}")
    dst.copy_(torch.tensor(arr))


def _dense(lin: nn.Linear, p: Mapping[str, Any]) -> None:
    _copy(lin.weight, p["kernel"], transpose=True)
    if lin.bias is not None:
        _copy(lin.bias, p["bias"])
    elif "bias" in p:
        raise ValueError("the flax Dense has a bias the Linear lacks")


def _time2vec(mod: nn.Module, p: Mapping[str, Any]) -> None:
    _copy(mod.w.weight, p["w"], transpose=True)
    _copy(mod.w.bias, p["b"])


@torch.no_grad()
def load_tgn_params(params: Mapping[str, Any], memory: nn.Module, encoder: nn.Module,
                    decoder: nn.Module) -> None:
    """Copy the flax tree ``{"mem", "enc", "dec"}`` into the three modules, in place."""
    mem = params["mem"]["params"]
    _time2vec(memory.time_enc, mem["time_enc"])
    gru = mem["gru"]
    _copy(memory.gru.weight_ih, gru["wi"], transpose=True)
    _copy(memory.gru.bias_ih, gru["bi"])
    _copy(memory.gru.weight_hh, gru["wh"], transpose=True)
    _copy(memory.gru.bias_hh, gru["bh"])

    enc = params["enc"]["params"]
    _time2vec(encoder.time_enc, enc["time_enc"])
    for name in ("lin_query", "lin_key", "lin_value", "lin_edge", "lin_skip"):
        _dense(getattr(encoder, name), enc[name])

    mlp = params["dec"]["params"]["mlp"]
    linears = [m for m in decoder.model if isinstance(m, nn.Linear)]
    if len(linears) != len(mlp):
        raise ValueError(f"decoder has {len(linears)} Linear layers, the tree {len(mlp)}")
    for i, lin in enumerate(linears):
        _dense(lin, mlp[f"Dense_{i}"])
