"""Fused DyGFormer transformer-stack forward: kernel K5 and its plain version.

Port of ``tgm_tpu/ops/pallas/dyg_transformer.py``. ``transformer_stack_fwd``
runs a pre-LN transformer stack in eval (no dropout), ``num_layers`` times::

    h = h + Wo(MHA(LN1(h)));  h = h + W2(gelu(W1(LN2(h))))

with bf16 matmul operands, fp32 accumulation, fp32 LayerNorm (biased
variance, eps 1e-5) and fp32 softmax, rounding to bf16 where the Pallas
kernel does: the LayerNorm outputs, the weights, q, k and v, the softmax
probabilities, the concatenated head outputs and the gelu output. Biases are
added in fp32 before rounding; logits are scaled after the q.k product; gelu
is the exact (erf) one.

Layers are flat dicts with the Pallas kernel's keys (``LAYER_KEYS``):
``wqkv`` (D, 3D) = [q | k | v] with heads contiguous inside each, ``wo``
(D, D), ``w1`` (D, F), ``w2`` (F, D), the biases and LayerNorm parameters.
``stack_weights`` converts them once to the kernel's layout (bf16 weights
padded with zeros to multiples of 16, fp32 biases and LayerNorm parameters).
On a CUDA tensor the wrapper launches ``csrc/dyg_transformer.cu``; on a CPU
tensor it runs the plain version, which batches over sequences and heads.
Unlike the Pallas kernel it takes any number of sequences (no ``block_b``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from . import _native

LAYER_KEYS = (
    "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
    "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2",
)
TILE = 16
MAX_FFN_CHUNK_TILES = 10  # the kernel's FFN chunk is at most 160 hidden columns
MAX_SEQ_LEN = 64

Layer = Dict[str, torch.Tensor]


def convert_flax_layer(p: Mapping[str, Any]) -> Layer:
    """Flat per-layer dict from a flax ``TransformerEncoder`` subtree (flax-MHA
    layout: query/key/value kernels (D, H, dh), out kernel (H, dh, D))."""
    mha = p["MultiHeadDotProductAttention_0"]
    a = lambda v: torch.tensor(np.asarray(v, dtype=np.float32))
    D = np.asarray(mha["out"]["kernel"]).shape[-1]
    qkv = [mha[n] for n in ("query", "key", "value")]
    return {
        "ln1_scale": a(p["LayerNorm_0"]["scale"]),
        "ln1_bias": a(p["LayerNorm_0"]["bias"]),
        "wqkv": torch.cat([a(q["kernel"]).reshape(D, D) for q in qkv], dim=1),
        "bqkv": torch.cat([a(q["bias"]).reshape(D) for q in qkv]),
        "wo": a(mha["out"]["kernel"]).reshape(D, D),
        "bo": a(mha["out"]["bias"]),
        "ln2_scale": a(p["LayerNorm_1"]["scale"]),
        "ln2_bias": a(p["LayerNorm_1"]["bias"]),
        "w1": a(p["Dense_0"]["kernel"]),
        "b1": a(p["Dense_0"]["bias"]),
        "w2": a(p["Dense_1"]["kernel"]),
        "b2": a(p["Dense_1"]["bias"]),
    }


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class StackWeights:
    """The stack's weights, converted once to the kernel's layout.

    ``w`` packs each layer's bf16 [Wqkv | Wo | W1 | W2] and ``p`` its fp32
    [ln1 scale | ln1 bias | bqkv | bo | ln2 scale | ln2 bias | b1 | b2], padded
    with zeros: D to ``DP``, each head's dh to ``DHP`` (per head q | k | v
    columns in Wqkv, per head rows in Wo), the FFN width to ``F`` (a multiple
    of the kernel's chunk ``FC``). ``layers`` keeps the fp32 dicts, which the
    plain version reads.
    """

    layers: List[Layer]
    num_heads: int
    D: int
    F: int
    FC: int
    w: torch.Tensor
    p: torch.Tensor

    @property
    def num_layers(self) -> int:
        return len(self.layers)


def _pad(t: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def stack_weights(layers: Sequence[Layer], num_heads: int) -> StackWeights:
    """Convert flat per-layer dicts to the kernel's padded bf16/fp32 layout."""
    layers = [{k: lp[k].float() for k in LAYER_KEYS} for lp in layers]
    if not layers:
        raise ValueError("the stack needs at least one layer")
    D, F = layers[0]["w1"].shape
    H = num_heads
    if D % H:
        raise ValueError(f"D={D} is not a multiple of num_heads={H}")
    dh = D // H
    DP, DHP = _round_up(D, TILE), _round_up(dh, TILE)
    FP = _round_up(F, TILE)
    tiles = FP // TILE
    FC = TILE * max(d for d in range(1, MAX_FFN_CHUNK_TILES + 1) if tiles % d == 0)
    ws, ps = [], []
    for lp in layers:
        dev = lp["wqkv"].device
        wqkv = torch.zeros((DP, 3 * H * DHP), device=dev)
        bqkv = torch.zeros(3 * H * DHP, device=dev)
        wo = torch.zeros((H * DHP, DP), device=dev)
        for h in range(H):
            for which in range(3):
                src = slice(which * D + h * dh, which * D + (h + 1) * dh)
                dst = slice((3 * h + which) * DHP, (3 * h + which) * DHP + dh)
                wqkv[:D, dst] = lp["wqkv"][:, src]
                bqkv[dst] = lp["bqkv"][src]
            wo[h * DHP:h * DHP + dh, :D] = lp["wo"][h * dh:(h + 1) * dh]
        ws += [wqkv.flatten(), wo.flatten(), _pad(lp["w1"], (DP, FP)).flatten(),
               _pad(lp["w2"], (FP, DP)).flatten()]
        ps += [_pad(lp["ln1_scale"], (DP,)), _pad(lp["ln1_bias"], (DP,)), bqkv,
               _pad(lp["bo"], (DP,)), _pad(lp["ln2_scale"], (DP,)), _pad(lp["ln2_bias"], (DP,)),
               _pad(lp["b1"], (FP,)), _pad(lp["b2"], (DP,))]
    return StackWeights(layers=layers, num_heads=H, D=D, F=FP, FC=FC,
                        w=torch.cat(ws).to(torch.bfloat16), p=torch.cat(ps))


Stack = Union[StackWeights, Sequence[Layer]]


def _as_stack(layers: Stack, num_heads: int) -> StackWeights:
    if isinstance(layers, StackWeights):
        if layers.num_heads != num_heads:
            raise ValueError(f"weights converted for {layers.num_heads} heads, got {num_heads}")
        return layers
    return stack_weights(layers, num_heads)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back: the kernel's operand rounding."""
    return t.to(torch.bfloat16).float()


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def transformer_stack_fwd_plain(x: torch.Tensor, layers: Stack, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K5: fp32 matmuls of bf16-rounded operands."""
    stack = layers.layers if isinstance(layers, StackWeights) else layers
    R, S, D = x.shape
    H = num_heads
    dh = D // H
    scale = 1.0 / math.sqrt(dh)
    h = x.float()
    for lp in stack:
        hn = _bf16(_layer_norm(h, lp["ln1_scale"], lp["ln1_bias"]))
        qkv = hn @ _bf16(lp["wqkv"]) + lp["bqkv"]  # (R, S, 3D)
        q, k, v = (_bf16(qkv[..., i * D:(i + 1) * D]).reshape(R, S, H, dh).transpose(1, 2)
                   for i in range(3))  # (R, H, S, dh)
        a = _bf16(torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1))
        o = (a @ v).transpose(1, 2).reshape(R, S, D)
        h = h + (_bf16(o) @ _bf16(lp["wo"]) + lp["bo"])
        hn = _bf16(_layer_norm(h, lp["ln2_scale"], lp["ln2_bias"]))
        g = _bf16(torch.nn.functional.gelu(hn @ _bf16(lp["w1"]) + lp["b1"]))
        h = h + (g @ _bf16(lp["w2"]) + lp["b2"])
    return h


def _smem_bytes(S: int, D: int, H: int, F: int, FC: int) -> int:
    """Shared memory one block of K5 needs, as the kernel's launcher computes it."""
    fn = _native.load("dyg_transformer").dyg_transformer_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(S, D, H, F, FC)


def transformer_stack_fwd(x: torch.Tensor, layers: Stack, num_heads: int) -> torch.Tensor:
    """Fused forward of the whole stack over (R, S, D) fp32 sequences.

    ``layers`` is a list of flat dicts or, converted once, ``StackWeights``.
    Kernel K5 on CUDA tensors (S a multiple of 16, at most 64), the plain
    version on CPU tensors; ``transformer_stack_fwd.launches`` counts kernel
    launches.
    """
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (R, S, D) float32, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return transformer_stack_fwd_plain(x, layers, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    stack = _as_stack(layers, num_heads)
    R, S, D = x.shape
    if D != stack.D:
        raise ValueError(f"x has width {D}, the weights {stack.D}")
    if S % TILE or not TILE <= S <= MAX_SEQ_LEN:
        raise ValueError(f"the kernel takes sequences of 16, 32, 48 or 64 rows, got {S}")
    for name, t, dtype in (("w", stack.w, torch.bfloat16), ("p", stack.p, torch.float32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"weights {name} must be contiguous {dtype} on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    smem = _smem_bytes(S, D, num_heads, stack.F, stack.FC)
    if smem > _native.MAX_SHARED_BYTES:
        raise ValueError(f"one sequence needs {smem} bytes of shared memory, the card "
                         f"gives a block {_native.MAX_SHARED_BYTES}")
    out = torch.empty((R, S, D), dtype=torch.float32, device=x.device)
    if R == 0:
        return out
    _native.launch("dyg_transformer", "dyg_transformer_stack_fwd",
                   [x.contiguous(), out, stack.w, stack.p],
                   [R, S, D, num_heads, stack.F, stack.FC, stack.num_layers])
    transformer_stack_fwd.launches += 1
    return out


transformer_stack_fwd.launches = 0


def stack_flops(R: int, S: int, D: int, F: int, num_layers: int) -> int:
    """Multiply-add operations x 2 of the stack's products (unpadded)."""
    per_layer = 2 * S * D * 3 * D + 2 * 2 * S * S * D + 2 * S * D * D + 2 * 2 * S * D * F
    return R * num_layers * per_layer
