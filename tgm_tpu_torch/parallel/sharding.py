"""Sharding layouts for temporal-GNN training state (port of
``tgm_tpu/parallel/sharding.py``).

The scaling strategy is the JAX package's:

* **DP over the edge stream**: each batch's edge axis is split over the
  ``data`` mesh axis: every rank takes a contiguous slice of the batch.
* **Node-sharded state**: TGN memory rows, recency ring buffers and message
  stores are split by node id over the same axis.
* **Replicated params and optimizer** (1-D), or on a 2-D (data, model) mesh
  parameter matrices split over ``model`` (tensor parallelism) with Adam's
  moments following their parameter.

JAX describes a layout with ``NamedSharding`` trees and GSPMD moves the
arrays and inserts the collectives. Here a layout function returns the same
tree of ``Sharding`` descriptions (a mesh, a per-dimension spec of axis
names as ``PartitionSpec`` has it, and whether the rows end in a dump row),
``place`` keeps each rank's part of a tree (the ``jax.device_put``
counterpart), ``gather`` rebuilds the whole tree on every rank (for
comparison), and ``parallel/spmd.py`` writes the steps with explicit
collectives.

Rows: a node-state tensor has N + 1 rows, the last the dump row. Its N real
rows are split into contiguous ranges balanced within one (as
``split_spans`` splits batches), and each rank keeps its range plus a dump
row of its own: every shard is again (n + 1) rows ending in a dump row,
which is the contract kernels K1 and K4, the push and the store commit take.
A batch's edges are split the same way, without a dump row.

Tensor parallelism: the JAX rule column-shards a flax kernel (in, out) on
its last axis when ``out`` divides the model axis size and replicates 1-D
leaves. A torch ``nn.Linear.weight`` is (out, in), so the port's rule
splits dim 0 of a parameter of two dimensions or more when it divides the
model axis size, and replicates the rest.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.batch import DGBatch
from .mesh import MeshAxis
from .temporal import split_spans


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: ``spec`` names the mesh axis each
    leading dimension is split over (None: not split; ``()``: replicated),
    and ``dump_row`` marks node-state rows whose last row is the dump row."""

    mesh: Any
    spec: Tuple[Optional[str], ...] = ()
    dump_row: bool = False


def _is_carry(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields") and "opt_state" in x._fields


def _opt_tree(opt: torch.optim.Optimizer, params: nn.Module) -> Dict[str, Dict[str, Any]]:
    """Adam's state by parameter name (its moments have the parameter's
    shape; before the first step they are described by the parameter)."""
    out = {}
    for (name, p), q in zip(params.named_parameters(), opt.param_groups[0]["params"]):
        st = opt.state.get(q)
        out[name] = dict(st) if st else {"step": torch.zeros(()), "exp_avg": q, "exp_avg_sq": q}
    return out


def _tree(x: Any) -> Any:
    """The tensor leaves of ``x`` as a nested structure: a module as its
    named parameters, a batch as its tensor attributes."""
    if isinstance(x, nn.Module):
        return dict(x.named_parameters())
    if isinstance(x, DGBatch):
        return {k: v for k, v in vars(x).items() if isinstance(v, torch.Tensor)}
    return x


def _tree_map(fn, x: Any) -> Any:
    x = _tree(x)
    if isinstance(x, Sharding):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def row_sharded(mesh, axis: str = "data") -> Sharding:
    return Sharding(mesh, (axis,))


def shard_leading_axis(mesh, tree: Any, axis: str = "data") -> Any:
    """Sharding tree: the leading axis of every tensor split over ``axis``;
    0-dim tensors and other leaves replicated."""

    def spec(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            return Sharding(mesh, (axis,) + (None,) * (x.dim() - 1))
        return Sharding(mesh, ())

    return _tree_map(spec, tree)


def replicate_tree(mesh, tree: Any) -> Any:
    return _tree_map(lambda _: Sharding(mesh, ()), tree)


def _state_rows(mesh, tree: Any, axis: str) -> Any:
    return _tree_map(lambda s: s._replace(dump_row=bool(s.spec)),
                     shard_leading_axis(mesh, tree, axis))


def tgn_carry_shardings(mesh, carry, axis: str = "data"):
    """Layout of a TGN training carry: memory and recency rows node-sharded
    (each shard with its own dump row); params, Adam and rng replicated."""
    return type(carry)(
        params=replicate_tree(mesh, carry.params),
        opt_state=replicate_tree(mesh, _opt_tree(carry.opt_state, carry.params)),
        mem_state=_state_rows(mesh, carry.mem_state, axis),
        rec_state=_state_rows(mesh, carry.rec_state, axis),
        rng=Sharding(mesh, ()),
    )


def batch_shardings(mesh, batch: Any, axis: str = "data") -> Any:
    """DP layout: the edge axis of every batch tensor split over ``axis``."""
    return shard_leading_axis(mesh, batch, axis)


def tp_param_shardings(mesh, params: Any, axis: str = "model") -> Any:
    """Tensor-parallel layout: tensors of two dimensions or more whose dim 0
    (a torch ``Linear``'s output features) divides the ``axis`` size are
    split on it; everything else replicated. Takes a module (its named
    parameters) or a tree of tensors (Adam's state by parameter name)."""
    size = MeshAxis(mesh, axis).size

    def spec(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 and x.shape[0] % size == 0:
            return Sharding(mesh, (axis,) + (None,) * (x.dim() - 1))
        return Sharding(mesh, ())

    return _tree_map(spec, params)


def tgat_carry_shardings(mesh, carry, axis: str = "data"):
    """Layout of a TGAT training carry (params, opt_state, rec_state, rng):
    recency rows node-sharded, params and Adam replicated."""
    return type(carry)(
        params=replicate_tree(mesh, carry.params),
        opt_state=replicate_tree(mesh, _opt_tree(carry.opt_state, carry.params)),
        rec_state=_state_rows(mesh, carry.rec_state, axis),
        rng=Sharding(mesh, ()),
    )


def tgat_carry_shardings_2d(mesh, carry):
    """DP + TP layout of a TGAT carry on a ('data', 'model') mesh."""
    return type(carry)(
        params=tp_param_shardings(mesh, carry.params),
        opt_state=tp_param_shardings(mesh, _opt_tree(carry.opt_state, carry.params)),
        rec_state=_state_rows(mesh, carry.rec_state, "data"),
        rng=Sharding(mesh, ()),
    )


def tgn_carry_shardings_2d(mesh, carry):
    """DP + TP layout on a ('data', 'model') mesh: node-state rows sharded on
    'data', parameter matrices split on 'model', Adam's moments following
    their parameters, rng replicated."""
    return type(carry)(
        params=tp_param_shardings(mesh, carry.params),
        opt_state=tp_param_shardings(mesh, _opt_tree(carry.opt_state, carry.params)),
        mem_state=_state_rows(mesh, carry.mem_state, "data"),
        rec_state=_state_rows(mesh, carry.rec_state, "data"),
        rng=Sharding(mesh, ()),
    )


# --------------------------------------------------------------------- #
def is_split(s: Sharding) -> bool:
    return bool(s.spec) and s.spec[0] is not None


def _part(x: torch.Tensor, s: Sharding) -> torch.Tensor:
    """This rank's part of ``x`` under ``s`` (a copy for state rows)."""
    if not is_split(s):
        return x
    ax = MeshAxis(s.mesh, s.spec[0])
    if s.dump_row:
        n = x.shape[0] - 1
        lo, hi = split_spans(n, ax.size)[ax.index]
        return torch.cat([x[lo:hi], x[n:]])
    lo, hi = split_spans(x.shape[0], ax.size)[ax.index]
    return x[lo:hi].clone()


def _place_params(params: nn.Module, opt: torch.optim.Optimizer, layout: Dict[str, Sharding]):
    """(params, Adam) under a parameter layout: with no split leaf, the
    same objects; else the same modules (the gathered working copy the
    steps compute with) and an Adam over this rank's parts: the split
    parameters' rows as parameters of their own, the others the modules'
    own, each with its part of the state."""
    if not any(is_split(s) for s in layout.values()):
        return params, opt
    named = list(params.named_parameters())
    masters = [nn.Parameter(_part(p.detach(), layout[n]).clone()) if is_split(layout[n]) else p
               for n, p in named]
    new = type(opt)(masters, **opt.defaults)
    for (n, p), m in zip(named, masters):
        st = opt.state.get(p)
        if st:
            new.state[m] = {k: _part(v, layout[n]) if v.dim() and is_split(layout[n])
                            else v.clone() for k, v in st.items()}
    return params, new


def place(tree: Any, shardings: Any) -> Any:
    """Keep this rank's part of ``tree`` under ``shardings`` (the layout
    functions' output): the counterpart of ``jax.device_put(tree,
    shardings)``. A carry's node-state rows become the rank's range plus a
    dump row; a batch keeps its slice of edges and records the whole batch's
    edge count and the slice's offset (``global_size``, ``global_offset``,
    host ints); split parameters go to an Adam over this rank's parts."""
    if _is_carry(tree):
        params, opt = _place_params(tree.params, tree.opt_state, shardings.params)
        rest = {f: place(getattr(tree, f), getattr(shardings, f)) for f in tree._fields
                if f not in ("params", "opt_state")}
        return type(tree)(params=params, opt_state=opt, **rest)
    if isinstance(tree, DGBatch):
        parts = {k: _part(getattr(tree, k), s) for k, s in shardings.items()}
        B = tree.edge_src.shape[0]
        s = shardings["edge_src"]
        lo = 0
        if is_split(s):
            ax = MeshAxis(s.mesh, s.spec[0])
            lo = split_spans(B, ax.size)[ax.index][0]
        return tree.replace(global_size=B, global_offset=lo, **parts)
    if isinstance(tree, torch.Tensor):
        return _part(tree, shardings)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(t, s) for t, s in zip(tree, shardings)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(place(t, s) for t, s in zip(tree, shardings))
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    return tree


def _whole(x: torch.Tensor, s: Sharding) -> torch.Tensor:
    """Every rank's part of ``x`` put back together, on every rank."""
    if not is_split(s):
        return x
    ax = MeshAxis(s.mesh, s.spec[0])
    rows = x.shape[0] - 1 if s.dump_row else x.shape[0]
    sizes = ax.all_gather(torch.tensor([rows], device=x.device)).reshape(-1).tolist()
    pad = max(sizes) - rows
    body = x[:rows]
    if pad:
        body = torch.cat([body, body.new_zeros((pad,) + tuple(body.shape[1:]))])
    parts = ax.all_gather(body)
    out = torch.cat([parts[r, :n] for r, n in enumerate(sizes)])
    return torch.cat([out, x[rows:]]) if s.dump_row else out


def gather(tree: Any, shardings: Any) -> Any:
    """The inverse of ``place``: the whole tree on every rank (every rank
    calls it). A carry with split parameters comes back with copies of the
    modules holding the whole parameters and an Adam over them with the
    whole state."""
    if _is_carry(tree):
        params, opt = tree.params, tree.opt_state
        layout = shardings.params
        if any(is_split(s) for s in layout.values()):
            memo: dict = {}
            params = copy.deepcopy(tree.params, memo)
            named = list(params.named_parameters())
            masters = tree.opt_state.param_groups[0]["params"]
            opt = type(tree.opt_state)([p for _, p in named], **tree.opt_state.defaults)
            with torch.no_grad():
                for (n, p), m in zip(named, masters):
                    s = layout[n]
                    p.copy_(_whole(m.detach(), s))
                    st = tree.opt_state.state.get(m)
                    if st:
                        opt.state[p] = {k: _whole(v, s) if v.dim() and is_split(s) else v.clone()
                                        for k, v in st.items()}
        rest = {f: gather(getattr(tree, f), getattr(shardings, f)) for f in tree._fields
                if f not in ("params", "opt_state")}
        return type(tree)(params=params, opt_state=opt, **rest)
    if isinstance(tree, torch.Tensor):
        return _whole(tree, shardings)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather(t, s) for t, s in zip(tree, shardings)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather(t, s) for t, s in zip(tree, shardings))
    if isinstance(tree, dict):
        return {k: gather(v, shardings[k]) for k, v in tree.items()}
    return tree


__all__ = [
    "Sharding",
    "batch_shardings",
    "gather",
    "is_split",
    "place",
    "replicate_tree",
    "replicated",
    "row_sharded",
    "shard_leading_axis",
    "tgat_carry_shardings",
    "tgat_carry_shardings_2d",
    "tgn_carry_shardings",
    "tgn_carry_shardings_2d",
    "tp_param_shardings",
]
