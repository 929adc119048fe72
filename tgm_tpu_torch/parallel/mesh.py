"""Process meshes over ``torch.distributed`` (port of ``tgm_tpu/parallel/mesh.py``).

A JAX mesh names devices of one program; here each device is one process
(a rank) of a ``torch.distributed`` group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks with named axes.
The default is the card with NCCL; the CPU with gloo only when the caller
asks for it (``device_type="cpu"``, ``backend="gloo"``). Ranks that share
one card (more ranks than cards, as on a one-card machine) use gloo with
``device_type="cuda"``: NCCL refuses two ranks on one device.

A process group is never found from the environment by itself: the caller
gives ``initialize_distributed`` the group's address (``init_method``, e.g.
``tcp://localhost:<port>`` or ``file://<path>``), ``world_size`` and
``rank``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)`` with NCCL as the
    default backend; nothing if a group already exists."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl")
    dist.init_process_group(**kwargs)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data",),
    devices: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over the ranks ``devices`` (default: every rank of the
    group), one rank per device; defaults to a 1-D ``data`` mesh over all of
    them. Asking for more ranks than there are raises ``ValueError``, before
    any group is touched. Every rank of the group calls it (a mesh makes its
    axis subgroups collectively)."""
    ranks = list(devices if devices is not None else range(_world_size()))
    if axis_sizes is None:
        axis_sizes = [len(ranks)] + [1] * (len(axis_names) - 1)
    total = int(np.prod(axis_sizes))
    if total > len(ranks):
        raise ValueError(f"mesh needs {total} devices, have {len(ranks)}")
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} axis names")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    mesh = torch.tensor(ranks[:total], dtype=torch.int64).reshape(list(axis_sizes))
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axis_names))


def data_model_mesh(data: int, model: int, devices: Optional[Sequence[int]] = None,
                    device_type: str = "cuda") -> DeviceMesh:
    """2-D (data, model) mesh: data-parallel outer, model-parallel inner, so
    a model group is consecutive ranks."""
    return make_mesh([data, model], ("data", "model"), devices, device_type)


class MeshAxis:
    """One named axis of a mesh as this rank sees it: its process group,
    its size and this rank's index on it. An axis the mesh lacks has size 1.

    The collectives run on the tensors' own device, except that gloo's
    (ranks sharing one card) are staged through pinned host memory for CUDA
    tensors: the compute stays on the card, only the collective's buffer
    crosses to the host and back.
    """

    def __init__(self, mesh: DeviceMesh, name: str) -> None:
        self.name = name
        names = mesh.mesh_dim_names or ()
        if name in names:
            self.group = mesh.get_group(name)
            self.size = mesh.size(names.index(name))
            self.index = mesh.get_local_rank(name)
        else:
            self.group, self.size, self.index = None, 1, 0

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and dist.get_backend(self.group) == "gloo":
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x)
            return buf
        return x.contiguous()

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the axis, in place."""
        if self.size > 1:
            buf = self._staged(x)
            dist.all_reduce(buf, group=self.group)
            if buf is not x:
                x.copy_(buf)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x`` (equal shapes), in axis order."""
        if self.size == 1:
            return x[None]
        buf = self._staged(x)
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(outs, buf, group=self.group)
        return torch.stack(outs).to(x.device)

    def all_to_all(self, x: torch.Tensor, send: Sequence[int], recv: Sequence[int]) -> torch.Tensor:
        """Rows of ``x`` exchanged over the axis: its first ``send[0]`` rows
        go to axis rank 0, the next ``send[1]`` to rank 1 and so on; returns
        the ``recv[r]`` rows from each rank r, in axis order."""
        if self.size == 1:
            return x
        buf = self._staged(x)
        out = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype, device=buf.device,
                          pin_memory=buf is not x and x.is_cuda)
        dist.all_to_all_single(out, buf, list(recv), list(send), group=self.group)
        return out.to(x.device)


__all__ = ["MeshAxis", "data_model_mesh", "initialize_distributed", "make_mesh"]
