"""K5's plain version against the Pallas ``transformer_stack_fwd`` (interpret mode).

Inputs and LayerNorm/bias perturbations come from numpy seeds; the layers
are the flax ``TransformerEncoder``'s, converted by each package's
``convert_flax_layer``.

Tolerances. Both versions round to bf16 at the same places, but they sum in
fp32 in different orders (XLA's dot against torch's), and exp and gelu (erf
against the Pallas polynomial) differ in the last fp32 bit. Where such an
ulp straddles a bf16 rounding boundary, the two round apart by one bf16 ulp
(2^-8 relative), and through attention that moves the whole sequence: over
seeds 0-2 at (8, 16, 32), H 2, L 2, the largest difference was 2.2e-3 *
max |Pallas| on one seed and 1.3e-4 on another, with a few hundred of the
4,096 elements above 1e-4 where a flip happened and none where it did not.
A bound of 1e-3 * max therefore depends on the seed. The test holds the
bulk tightly (median |port - Pallas| <= 1e-6 * max |Pallas|) and the
largest difference to 5e-3 * max |Pallas|, K5's bound against its plain
version on the card. The layer conversion must match exactly; the kernel's
padded weight layout, read back in plain fp32 arithmetic, within 1e-5 of
the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.nn.encoder.dygformer import TransformerEncoder
from tgm_tpu.ops.pallas.dyg_transformer import convert_flax_layer as j_convert
from tgm_tpu.ops.pallas.dyg_transformer import transformer_stack_fwd as pallas_stack
from tgm_tpu_torch.ops import convert_flax_layer, stack_weights, transformer_stack_fwd
from tgm_tpu_torch.ops.dyg_transformer import (
    LAYER_KEYS,
    transformer_stack_fwd_plain,
    transformer_stack_stage_ms,
)


def flax_layers(seed, R, S, D, H, L):
    """Flax stack params with LayerNorm parameters and biases moved off their
    init (ones/zeros), so that every parameter reaches the output."""
    rng = np.random.default_rng(seed)
    noise = lambda scale, shape: (scale * rng.normal(size=shape)).astype(np.float32)
    x = rng.normal(size=(R, S, D)).astype(np.float32)
    mods = [TransformerEncoder(attention_dim=D, num_heads=H, dropout=0.0) for _ in range(L)]
    keys = jax.random.split(jax.random.PRNGKey(seed), L)
    trees = [jax.tree_util.tree_map(np.asarray, m.init(k, jnp.asarray(x))["params"])
             for m, k in zip(mods, keys)]
    for t in trees:
        for name in ("LayerNorm_0", "LayerNorm_1", "Dense_0", "Dense_1"):
            t[name]["bias"] = t[name]["bias"] + noise(0.1, t[name]["bias"].shape)
        for name in ("LayerNorm_0", "LayerNorm_1"):
            t[name]["scale"] = t[name]["scale"] + noise(0.2, t[name]["scale"].shape)
        for name in ("query", "key", "value", "out"):
            b = t["MultiHeadDotProductAttention_0"][name]["bias"]
            t["MultiHeadDotProductAttention_0"][name]["bias"] = b + noise(0.1, b.shape)
    return x, trees


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("R, S, D, H, L", [(8, 16, 32, 2, 2), (4, 32, 48, 3, 1), (8, 8, 40, 2, 2)])
def test_plain_matches_pallas_interpret(R, S, D, H, L, seed):
    x, trees = flax_layers(7 * seed + D, R, S, D, H, L)
    j_layers = [j_convert(t) for t in trees]
    ref = np.asarray(pallas_stack(jnp.asarray(x), j_layers, num_heads=H, block_b=4,
                                  interpret=True))
    layers = [convert_flax_layer(t) for t in trees]
    got = transformer_stack_fwd(torch.from_numpy(x), layers, H).numpy()
    scale = np.abs(ref).max()
    diff = np.abs(got - ref)
    assert np.median(diff) <= 1e-6 * scale  # the bulk: no rounding flip reaches it
    assert diff.max() <= 5e-3 * scale  # a flipped bf16 rounding moves its sequence
    # The stack moved its input: the comparison is not of a near identity.
    assert np.abs(ref - x).max() > 0.5


def test_convert_flax_layer_matches_jax():
    _, trees = flax_layers(0, 2, 8, 32, 2, 1)
    got, want = convert_flax_layer(trees[0]), j_convert(trees[0])
    assert tuple(got) == LAYER_KEYS
    for k in LAYER_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _stack_from_padded(x, sw):
    """The stack read from the kernel's packed, padded layout (``StackWeights``
    ``w`` and ``p``), in fp32 with the plain version's roundings: what the
    kernel computes if its padding is exact."""
    R, S, D = x.shape
    H, F = sw.num_heads, sw.F
    dh = D // H
    DP, DHP = -(-D // 16) * 16, -(-dh // 16) * 16
    r = lambda t: t.to(torch.bfloat16).float()
    w, p = sw.w.float(), sw.p
    h = torch.zeros(R, S, DP)
    h[..., :D] = x

    def ln(v, g, b):
        mu = v[..., :D].mean(-1, keepdim=True)
        var = ((v[..., :D] - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-5) * g + b

    wo_, po = 0, 0
    for _ in range(sw.num_layers):
        def take_w(rows, cols):
            nonlocal wo_
            out = w[wo_:wo_ + rows * cols].reshape(rows, cols)
            wo_ += rows * cols
            return out

        def take_p(n):
            nonlocal po
            out = p[po:po + n]
            po += n
            return out

        wqkv, wo = take_w(DP, 3 * H * DHP), take_w(H * DHP, DP)
        w1, w2 = take_w(DP, F), take_w(F, DP)
        g1, b1n, bqkv, bo = take_p(DP), take_p(DP), take_p(3 * H * DHP), take_p(DP)
        g2, b2n, b1, b2 = take_p(DP), take_p(DP), take_p(F), take_p(DP)
        qkv = r(r(ln(h, g1, b1n)) @ wqkv + bqkv).reshape(R, S, H, 3, DHP)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # (R, H, S, DHP)
        a = r(torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / dh ** 0.5), dim=-1))
        o = r((a @ v).transpose(1, 2).reshape(R, S, H * DHP))
        h = h + (o @ wo + bo)
        g = r(torch.nn.functional.gelu(r(ln(h, g2, b2n)) @ w1 + b1))
        h = h + (g @ w2 + b2)
    assert wo_ == w.numel() and po == p.numel()
    assert (h[..., D:] == 0).all()  # the pad columns stay zero
    return h[..., :D]


@pytest.mark.parametrize("D, H, F", [(40, 2, 160), (200, 2, 800), (48, 3, 100)])
def test_padded_layout_computes_the_same_stack(D, H, F):
    """The packing of ``stack_weights`` (D -> DP, dh -> DHP, F -> a multiple
    of 16, per-head q | k | v) changes no sum."""
    rng = np.random.default_rng(D)
    n = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    layers = [dict(ln1_scale=1 + n(D, sc=0.1), ln1_bias=n(D, sc=0.1), wqkv=n(D, 3 * D, sc=D ** -0.5),
                   bqkv=n(3 * D, sc=0.1), wo=n(D, D, sc=D ** -0.5), bo=n(D, sc=0.1),
                   ln2_scale=1 + n(D, sc=0.1), ln2_bias=n(D, sc=0.1), w1=n(D, F, sc=D ** -0.5),
                   b1=n(F, sc=0.1), w2=n(F, D, sc=F ** -0.5), b2=n(D, sc=0.1)) for _ in range(2)]
    sw = stack_weights(layers, H)
    assert sw.F % 16 == 0 and sw.F >= F
    x = n(3, 16, D)
    want = transformer_stack_fwd_plain(x, layers, H)
    got = _stack_from_padded(x, sw)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_wrapper_checks_and_cpu_dispatch():
    x, trees = flax_layers(1, 2, 16, 32, 2, 1)
    layers = [convert_flax_layer(t) for t in trees]
    before = transformer_stack_fwd.launches
    out = transformer_stack_fwd(torch.from_numpy(x), stack_weights(layers, 2), 2)
    assert transformer_stack_fwd.launches == before  # the plain version ran: no launch
    assert out.shape == x.shape and out.dtype == torch.float32
    with pytest.raises(ValueError):
        transformer_stack_fwd(torch.from_numpy(x).double(), layers, 2)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        transformer_stack_fwd(torch.from_numpy(x).to("meta"), layers, 2)
    with pytest.raises(ValueError):
        stack_weights(layers, 3)  # 32 is not a multiple of 3 heads


def test_stage_timing_needs_a_card():
    """The per-stage diagnostic times kernels: it raises on a CPU tensor
    instead of timing the plain version."""
    x, trees = flax_layers(2, 2, 16, 32, 2, 1)
    sw = stack_weights([convert_flax_layer(t) for t in trees], 2)
    before = transformer_stack_fwd.launches
    with pytest.raises(ValueError):
        transformer_stack_stage_ms(torch.from_numpy(x), sw)
    assert transformer_stack_fwd.launches == before
