"""Seeded weights, made by the benchmark on the device in one draw.

Every parameter of the program's modules is named; the benchmark makes a
value for each name and hands the same dict to the program (copied into
its modules) and to the plain reference. Time2Vec keeps its published
initialisation (``w_i = 1 / 10^linspace(0, 9)``, zero phase); every other
parameter comes from one ``torch.randn`` on the device: a 2-D weight
(out, in) scaled by 1 / sqrt(in), a 1-D ``*.weight`` (a LayerNorm scale)
as 1 + 0.1 z, every other 1-D parameter as 0.1 z.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

_TIME2VEC = re.compile(r"(^|\.)time_enc(oder)?\.w\.(weight|bias)$")


def make(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    drawn = [(n, s) for n, s in shapes if not _TIME2VEC.search(n)]
    total = sum(int(np.prod(s)) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in drawn:
        n = int(np.prod(shape))
        v = z[off:off + n].reshape(shape)
        off += n
        if len(shape) == 2:
            v = v / float(np.sqrt(shape[1]))
        elif name.endswith(".weight"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.clone()
    for name, shape in shapes:
        if _TIME2VEC.search(name):
            T = shape[0]
            w = (1 / 10 ** np.linspace(0, 9, T)).astype(np.float32)
            out[name] = (torch.as_tensor(w, device=device).reshape(shape) if name.endswith("weight")
                         else torch.zeros(shape, device=device))
    return out


def load(modules: Dict[str, torch.nn.Module], W: Dict[str, torch.Tensor]) -> None:
    """Copy ``W`` into the modules' parameters (names ``<module>.<param>``)."""
    with torch.no_grad():
        for prefix, m in modules.items():
            for name, p in m.named_parameters():
                p.copy_(W[f"{prefix}.{name}"])


def shapes_of(modules: Dict[str, torch.nn.Module]):
    return [(f"{prefix}.{n}", tuple(p.shape)) for prefix, m in modules.items()
            for n, p in m.named_parameters()]
