"""The port's DyGFormer against the JAX ``DyGFormer`` with the Pallas stack.

The JAX encoder runs ``apply(..., pallas_layers=dygformer_pallas_layers(p, L))``
(the Pallas kernel in interpret mode on the CPU), the port the same weights
through ``load_dygformer_params`` and its stack's plain version. Inputs come
from numpy seeds: neighbour rows with PAD slots, repeated ids (so the
co-occurrence counts are not all one) and, in one case, more neighbours than
the sequence holds (trimmed) and patches of two.

Tolerances: the co-occurrence encoder and the converted stack layers
exactly or within 1e-6 (fp32, one Dense); the embeddings as in
``test_torch_dyg_transformer.py`` (a bf16 rounding that flips between two
fp32 summation orders moves a sequence): median |port - JAX| <= 1e-6 *
max |JAX|, largest <= 5e-3 * max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.nn import DyGFormer as JDyGFormer
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.dygformer import NeighborCooccurrenceEncoder as JCooc
from tgm_tpu.nn.encoder.dygformer import dygformer_pallas_layers
from tgm_tpu_torch.nn import DyGFormer, LinkPredictor, NeighborCooccurrenceEncoder
from tgm_tpu_torch.nn import dygformer_stack_layers
from tgm_tpu_torch.weights import load_dygformer_params

N_NODES, EDGE_DIM, TIME_DIM, CHANNEL, OUT = 30, 5, 8, 8, 16


def inputs(seed, B, K):
    rng = np.random.default_rng(seed)
    node_x = rng.normal(size=(N_NODES, 2)).astype(np.float32)
    src = rng.integers(0, N_NODES, B).astype(np.int32)
    dst = rng.integers(0, N_NODES, B).astype(np.int32)
    t = rng.integers(50, 100, B).astype(np.int32)
    nbrs = rng.integers(0, 6, (2 * B, K)).astype(np.int32)  # few ids: repeats
    nbrs[rng.random((2 * B, K)) < 0.3] = -1
    ntime = np.where(nbrs >= 0, rng.integers(0, 50, (2 * B, K)), 0).astype(np.int32)
    nfeat = np.where(nbrs[..., None] >= 0, rng.normal(size=(2 * B, K, EDGE_DIM)), 0.0)
    return node_x, src, dst, t, nbrs, ntime, nfeat.astype(np.float32)


def models(max_len, patch, seed=0):
    kw = dict(node_feat_dim=2, edge_x_dim=EDGE_DIM, time_feat_dim=TIME_DIM,
              channel_embedding_dim=CHANNEL, output_dim=OUT, patch_size=patch,
              max_input_sequence_length=max_len)
    j_enc = JDyGFormer(dropout=0.0, **kw)
    return j_enc, DyGFormer(**kw)


def jax_params(j_enc, args, seed=0):
    """JAX init, with LayerNorm parameters and zero-init biases moved off
    their init so that every parameter reaches the output."""
    rng = np.random.default_rng(100 + seed)
    p = jax.tree_util.tree_map(np.asarray, j_enc.init(jax.random.PRNGKey(seed),
                                                      *(jnp.asarray(a) for a in args)))

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bias", "scale", "b"):
                tree[k] = v + (0.1 * rng.normal(size=v.shape)).astype(np.float32)

    perturb(p)
    return p


@pytest.mark.parametrize("B, K, max_len, patch", [(8, 6, 8, 1), (4, 10, 8, 2), (6, 3, 16, 1)])
def test_forward_matches_jax_pallas_stack(B, K, max_len, patch):
    args = inputs(B + K, B, K)
    j_enc, enc = models(max_len, patch)
    p = jax_params(j_enc, args)
    j_dec = JLinkPredictor(node_dim=OUT, hidden_dim=OUT)
    dp = j_dec.init(jax.random.PRNGKey(1), jnp.zeros((1, OUT)), jnp.zeros((1, OUT)))
    dec = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
    load_dygformer_params({"enc": p, "dec": dp}, enc, dec)
    enc.eval()

    pl = dygformer_pallas_layers(p, j_enc.num_layers)
    want = j_enc.apply(p, *(jnp.asarray(a) for a in args), pallas_layers=pl)
    with torch.no_grad():
        got = enc(*(torch.from_numpy(a) for a in args), stack=enc.stack_weights())
    for g, w in zip(got, want):
        w = np.asarray(w)
        diff, scale = np.abs(g.numpy() - w), np.abs(w).max()
        assert np.median(diff) <= 1e-6 * scale and diff.max() <= 5e-3 * scale
    # The decoder was loaded too.
    with torch.no_grad():
        s = dec(*got).numpy()
    np.testing.assert_allclose(s, np.asarray(j_dec.apply(dp, *want)), rtol=0,
                               atol=5e-3 * np.abs(s).max())


def test_stack_layers_match_jax_pallas_layers():
    args = inputs(0, 4, 6)
    j_enc, enc = models(8, 1)
    p = jax_params(j_enc, args)
    dp = JLinkPredictor(node_dim=OUT, hidden_dim=OUT).init(
        jax.random.PRNGKey(1), jnp.zeros((1, OUT)), jnp.zeros((1, OUT)))
    load_dygformer_params({"enc": p, "dec": dp}, enc, LinkPredictor(node_dim=OUT, hidden_dim=OUT))
    got = dygformer_stack_layers(enc)
    want = dygformer_pallas_layers(p, 2)
    assert len(got) == len(want) == enc.num_layers
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_cooccurrence_encoder_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.integers(-1, 4, (5, 7)).astype(np.int32)
    d = rng.integers(-1, 4, (5, 7)).astype(np.int32)
    j_mod = JCooc(CHANNEL)
    p = j_mod.init(jax.random.PRNGKey(0), jnp.asarray(s), jnp.asarray(d))["params"]
    mod = NeighborCooccurrenceEncoder(CHANNEL)
    with torch.no_grad():
        for lin, name in zip((mod.enc[0], mod.enc[2]), ("Dense_0", "Dense_1")):
            lin.weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
        got = mod(torch.from_numpy(s), torch.from_numpy(d))
    want = j_mod.apply({"params": p}, jnp.asarray(s), jnp.asarray(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_load_rejects_other_layouts():
    args = inputs(0, 4, 6)
    dec = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
    dp = JLinkPredictor(node_dim=OUT, hidden_dim=OUT).init(
        jax.random.PRNGKey(1), jnp.zeros((1, OUT)), jnp.zeros((1, OUT)))
    fused = JDyGFormer(node_feat_dim=2, edge_x_dim=EDGE_DIM, time_feat_dim=TIME_DIM,
                       channel_embedding_dim=CHANNEL, output_dim=OUT,
                       max_input_sequence_length=8, fused_attn=True)
    p = fused.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="flax-MHA"):
        load_dygformer_params({"enc": p, "dec": dp}, models(8, 1)[1], dec)
    one_layer = DyGFormer(node_feat_dim=2, edge_x_dim=EDGE_DIM, time_feat_dim=TIME_DIM,
                          channel_embedding_dim=CHANNEL, output_dim=OUT, num_layers=1,
                          max_input_sequence_length=8)
    p = models(8, 1)[0].init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="layers"):
        load_dygformer_params({"enc": p, "dec": dp}, one_layer, dec)
