"""The bf16 options' modules, and K1's bf16 rows, against the JAX package on the CPU.

Each option must round where the JAX one rounds. JAX runs jitted with
XLA's excess precision off (``source_apply``), which rounds exactly where
flax's source says, as JAX op by op does
(``tgm_tpu_torch/nn/modules/bf16.py`` lists the points; by default XLA
keeps some fused bf16 results in fp32). Bands (ROADMAP
fault 2's: the CPU's XLA and torch sum fp32 products in different orders, so
a result near a bf16 rounding boundary flips by one bf16 ulp): max |diff| <=
5e-3 * max |JAX| and median |diff| <= 1e-6 * max |JAX|; a rounding at a
different point moves most values and fails the median. Output dtypes
equal.

* ``TemporalAttention(kv_bf16)`` (both score layouts, with and without the
  pre-concatenated K/V rows) and ``TGAT(kv_bf16)``.
* ``GraphAttentionEmbeddingRowwise(kv_bf16)`` (the three layouts, with and
  without ``nbr_msg_proj``) and ``rowwise_project_edge_feats``.
* ``LayerNormBF16``, ``TransformerEncoder`` in bf16 (with and without the
  stream, both attention layouts), ``DyGFormer(compute_bf16)`` on the
  layers' modules and through K5's plain version (JAX: the Pallas stack in
  interpret mode), and ``DyGFormer(compute_bf16, bf16_stream)``.
* ``load_dygformer_params`` on a ``bf16_stream`` tree; flax's ``dtype=``
  leaves the parameters fp32, so the TGN and TGAT trees load as before.
* K1's plain route over bf16 tables at D = 172, 100 and 173 (the TGN, the
  pre-projected and TGAT's side-augmented widths): bit for bit the JAX
  ``gather_edge_feats`` of the same table, zero rows for edge id -1.
* ``resolve_bf16`` and ``tpu_default_bf16`` keep the JAX contract.

Sizes: widths 8-16, a few dozen rows, made with numpy from a seed; weights
from JAX's init with biases and LayerNorm parameters moved off their init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.hooks.neighbors import gather_edge_feats as j_gather_edge_feats
from tgm_tpu.nn import TGAT as JTGAT
from tgm_tpu.nn import DyGFormer as JDyGFormer
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.dygformer import LayerNormBF16 as JLayerNormBF16
from tgm_tpu.nn.encoder.dygformer import TransformerEncoder as JTransformer
from tgm_tpu.nn.encoder.dygformer import dygformer_pallas_layers
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbeddingRowwise as JRowwise
from tgm_tpu.nn.encoder.tgn import rowwise_project_edge_feats as j_project
from tgm_tpu.nn.modules.attention import TemporalAttention as JAttention
from tgm_tpu.util.precision import resolve_bf16 as j_resolve_bf16
from tgm_tpu_torch.nn import (
    TGAT,
    DyGFormer,
    GraphAttentionEmbeddingRowwise,
    LinkPredictor,
    TemporalAttention,
    TransformerEncoder,
)
from tgm_tpu_torch.nn.encoder.tgn import rowwise_project_edge_feats
from tgm_tpu_torch.nn.modules.bf16 import LayerNormBF16
from tgm_tpu_torch.ops import recency_eid_select
from tgm_tpu_torch.ops.recency_select import gather_edge_feats
from tgm_tpu_torch.util import resolve_bf16, tpu_default_bf16
from tgm_tpu_torch.weights import (
    _tgn_encoder,
    load_dygformer_params,
    load_tgat_params,
    load_transformer_encoder_params,
)

BF = jnp.bfloat16


def source_apply(module, params, *args, **kwargs):
    """``module.apply(params, *args, **kwargs)`` jitted with XLA's excess
    precision off: each bf16 op rounds its result where the JAX source says,
    as JAX run op by op does (by default XLA keeps some fused bf16 results in
    fp32). Python bools among ``kwargs`` are static."""
    static = {k: v for k, v in kwargs.items() if isinstance(v, bool)}
    traced = {k: v for k, v in kwargs.items() if not isinstance(v, bool)}
    fn = jax.jit(lambda p, a, kw: module.apply(p, *a, **kw, **static))
    return fn.lower(params, args, traced).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, args, traced)


def jinit(module):
    """The module's ``init``, jitted: the parameters are only inputs here,
    and op by op the init would run the whole forward once more."""
    return jax.jit(module.init)


def perturbed(tree, seed):
    """The tree as numpy, biases and LayerNorm parameters moved off their init."""
    rng = np.random.default_rng(100 + seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("bias", "scale", "b"):
                t[k] = v + (0.1 * rng.normal(size=v.shape)).astype(np.float32)

    walk(tree)
    return tree


def assert_band(got, want):
    """Fault 2's bands: the max within 5e-3 * max |JAX|, the median within
    1e-6 * max |JAX|; dtypes equal. Returns the max and the median."""
    want_t = np.asarray(jnp.asarray(want).astype(jnp.float32))
    dt = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(BF): torch.bfloat16}[
        jnp.asarray(want).dtype]
    assert got.dtype == dt, (got.dtype, want.dtype)
    diff = np.abs(got.detach().float().numpy() - want_t)
    scale = float(np.abs(want_t).max())
    assert scale > 0
    assert diff.max() <= 5e-3 * scale, (diff.max(), scale)
    assert np.median(diff) <= 1e-6 * scale, (np.median(diff), scale)
    return float(diff.max()), float(np.median(diff))


def T(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------- #
# TGAT's attention
# ---------------------------------------------------------------------- #
H, NODE, EDGE, TIME = 2, 5, 7, 8


def attention_inputs(seed, B=24, K=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mask = rng.random((B, K)) < 0.6
    mask[0] = False  # a row with no valid neighbour
    mask[1] = True
    return f(B, NODE), f(B, TIME), f(B, K, EDGE), f(B, K, NODE), f(B, K, TIME), mask


def load_attention(p, mod):
    with torch.no_grad():
        for name in ("W_Q", "W_KV", "W_O"):
            lin = getattr(mod, name)
            lin.weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            if lin.bias is not None:
                lin.bias.copy_(torch.from_numpy(p[name]["bias"]))
        mod.layer_norm.weight.copy_(torch.from_numpy(p["layer_norm"]["scale"]))
        mod.layer_norm.bias.copy_(torch.from_numpy(p["layer_norm"]["bias"]))


@pytest.mark.parametrize("fused_kv", [False, True])
@pytest.mark.parametrize("layout", ["kmajor", "lanes"])
def test_temporal_attention_kv_bf16_matches_jax(layout, fused_kv):
    x, tf, ef, nf, ntf, mask = attention_inputs(1)
    j_mod = JAttention(n_heads=H, node_dim=NODE, edge_dim=EDGE, time_dim=TIME, kv_bf16=True,
                       score_layout=layout)
    p = perturbed(jinit(j_mod)(jax.random.PRNGKey(0), x, tf, ef, nf, ntf, mask), 0)
    # flax's dtype= changes the computation, not the parameters.
    assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(p))
    kv = np.concatenate([nf, ef], axis=-1) if fused_kv else None
    want = source_apply(j_mod, p, x, tf, None if fused_kv else ef, None if fused_kv else nf,
                        ntf, mask, kv_node_edge_feat=kv)
    mod = TemporalAttention(H, NODE, EDGE, TIME, kv_bf16=True, score_layout=layout)
    load_attention(p["params"], mod)
    got = mod(T(x), T(tf), None if fused_kv else T(ef), None if fused_kv else T(nf), T(ntf),
              T(mask), kv_node_edge_feat=T(kv))
    assert_band(got, want)
    # The rounding points matter: the fp32 module is off by far more than the band.
    f32 = source_apply(j_mod.clone(kv_bf16=False), p, x, tf, None if fused_kv else ef,
                       None if fused_kv else nf, ntf, mask, kv_node_edge_feat=kv)
    assert np.median(np.abs(np.asarray(f32) - np.asarray(want))) > 1e-4


def tgat_inputs(seed, N=30, S=12, ks=(4, 3)):
    rng = np.random.default_rng(seed)
    node_x = rng.normal(size=(N, NODE)).astype(np.float32)
    seeds = [rng.integers(0, N, S).astype(np.int32)]
    times = [rng.integers(100, 200, S).astype(np.int32)]
    nbrs, nt, nx = [], [], []
    for hop, k in enumerate(ks):
        if hop:
            seeds.append(nbrs[-1].reshape(-1))
            times.append(nt[-1].reshape(-1))
        s = seeds[-1].shape[0]
        nb = rng.integers(0, N, (s, k)).astype(np.int32)
        nb[rng.random((s, k)) < 0.3] = -1
        nb[0] = -1
        nbrs.append(nb)
        nt.append(np.where(nb >= 0, rng.integers(0, 100, (s, k)), 0).astype(np.int32))
        nx.append(np.where(nb[..., None] >= 0, rng.normal(size=(s, k, EDGE)), 0.0)
                  .astype(np.float32))
    return node_x, seeds, times, nbrs, nx, nt


@pytest.mark.parametrize("layout", ["kmajor", "lanes"])
def test_tgat_kv_bf16_matches_jax(layout):
    embed = 12
    node_x, *hops = tgat_inputs(3)
    j_enc = JTGAT(node_dim=NODE, edge_dim=EDGE, time_dim=TIME, embed_dim=embed, num_layers=2,
                  n_heads=H, dropout=0.0, kv_bf16=True, score_layout=layout)
    j_dec = JLinkPredictor(node_dim=embed)
    params = {"enc": perturbed(jinit(j_enc)(jax.random.PRNGKey(1), jnp.asarray(node_x), *hops), 1),
              "dec": jinit(j_dec)(jax.random.PRNGKey(2), jnp.zeros((1, embed)),
                                jnp.zeros((1, embed)))}
    # The deepest hop's [node ‖ edge] rows pre-concatenated, PAD slots holding
    # the wrapped last node row and zero edge features.
    ids = hops[2][1]
    kv = [None, np.concatenate([node_x[np.where(ids < 0, ids + len(node_x), ids)], hops[3][1]],
                               axis=-1)]
    want = source_apply(j_enc, params["enc"], jnp.asarray(node_x), *hops, nbr_kv_x=kv)
    enc = TGAT(NODE, EDGE, TIME, embed, 2, n_heads=H, dropout=0.0, kv_bf16=True,
               score_layout=layout)
    load_tgat_params(params, enc, LinkPredictor(node_dim=embed))
    L = lambda xs: [T(a) for a in xs]
    got = enc(T(node_x), *(L(h) for h in hops), nbr_kv_x=L(kv))
    assert_band(got, want)


# ---------------------------------------------------------------------- #
# TGN's rowwise attention
# ---------------------------------------------------------------------- #
M, EMB, RAW, TT, S, K = 12, 16, 10, 8, 40, 5


def rowwise_models(layout):
    j_mod = JRowwise(in_channels=M, out_channels=EMB, msg_dim=RAW, time_dim=TT, dropout=0.0,
                     kv_bf16=True, score_layout=layout)
    args = rowwise_inputs(0)
    p = perturbed(jinit(j_mod)(jax.random.PRNGKey(3), *args[:6]), 3)
    mod = GraphAttentionEmbeddingRowwise(M, EMB, RAW, TT, dropout=0.0, kv_bf16=True)
    with torch.no_grad():
        _tgn_encoder(mod, p["params"])
    return j_mod, p, mod


def rowwise_inputs(seed):
    rng = np.random.default_rng(seed)
    x_seed = rng.normal(size=(S, M)).astype(np.float32)
    x_nbr = rng.normal(size=(S, K, M)).astype(np.float32)
    last = rng.integers(50, 100, S).astype(np.int32)
    nbr_t = rng.integers(0, 50, (S, K)).astype(np.int32)
    msg = rng.normal(size=(S, K, RAW)).astype(np.float32)
    valid = rng.random((S, K)) < 0.6
    valid[0] = False  # a seed without neighbours
    table = rng.normal(size=(60, RAW)).astype(np.float32)
    return x_seed, x_nbr, last, nbr_t, msg, valid, table


@pytest.mark.parametrize("proj", [False, True])
@pytest.mark.parametrize("layout", ["lanesv", "lanes", "kmajor"])
def test_rowwise_kv_bf16_matches_jax(layout, proj):
    j_mod, p, mod = rowwise_models(layout)
    *args, table = rowwise_inputs(1)
    nbr_proj = None
    if proj:
        # Rows of the pre-projected (bf16) table, as eval_step gathers them.
        j_tab = j_project(p, jnp.asarray(table), TT, True)
        assert j_tab.dtype == BF
        got_tab = rowwise_project_edge_feats(mod, T(table))
        assert_band(got_tab, j_tab)
        rows = np.random.default_rng(2).integers(0, table.shape[0], (S, K))
        nbr_proj = np.asarray(j_tab)[rows]
    want = source_apply(j_mod, p, *(jnp.asarray(a) for a in args), nbr_msg_proj=nbr_proj)
    with torch.no_grad():
        got = mod(*(T(a) for a in args),
                  nbr_msg_proj=None if nbr_proj is None else
                  torch.from_numpy(np.asarray(jnp.asarray(nbr_proj).astype(jnp.float32)))
                  .to(torch.bfloat16))
    assert_band(got, want)


# ---------------------------------------------------------------------- #
# DyGFormer
# ---------------------------------------------------------------------- #
D = 32
DYG = dict(node_feat_dim=3, edge_x_dim=6, time_feat_dim=8, channel_embedding_dim=8,
           output_dim=16, patch_size=1, num_layers=2, num_heads=2,
           max_input_sequence_length=8)


def test_layer_norm_bf16_matches_jax():
    x = np.random.default_rng(4).normal(size=(64, D)).astype(np.float32) * 3 + 1
    j_mod = JLayerNormBF16()
    p = perturbed(jinit(j_mod)(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    for xin in (x, np.asarray(jnp.asarray(x).astype(BF))):
        want = source_apply(j_mod, p, jnp.asarray(xin))
        mod = LayerNormBF16(D)
        with torch.no_grad():
            mod.weight.copy_(T(p["params"]["scale"]))
            mod.bias.copy_(T(p["params"]["bias"]))
        assert_band(mod(T(np.asarray(jnp.asarray(xin).astype(jnp.float32)))
                        .to(torch.bfloat16 if xin.dtype != np.float32 else torch.float32)), want)


@pytest.mark.parametrize("fused_attn, stream", [(False, False), (True, False), (False, True),
                                                (True, True)])
def test_transformer_encoder_bf16_matches_jax(fused_attn, stream):
    x = np.random.default_rng(6).normal(size=(6, 12, D)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(BF).astype(jnp.float32))  # the bf16 patches
    j_mod = JTransformer(attention_dim=D, num_heads=2, dropout=0.1, dtype=BF,
                         fused_attn=fused_attn, bf16_stream=stream)
    p = perturbed(jinit(j_mod)(jax.random.PRNGKey(7), jnp.asarray(xb, BF)), 7)
    want = source_apply(j_mod, p, jnp.asarray(xb, BF), deterministic=True)
    mod = TransformerEncoder(D, 2, dropout=0.1, fused_attn=fused_attn, dtype=torch.bfloat16,
                             bf16_stream=stream)
    load_transformer_encoder_params(p["params"], mod)
    assert_band(mod(T(xb).to(torch.bfloat16)), want)


def dyg_inputs(seed, B=6, K=5):
    rng = np.random.default_rng(seed)
    node_x = rng.normal(size=(20, DYG["node_feat_dim"])).astype(np.float32)
    src, dst = rng.integers(0, 20, (2, B)).astype(np.int32)
    t = rng.integers(500, 1000, B).astype(np.int32)
    nbrs = rng.integers(0, 20, (2 * B, K)).astype(np.int32)
    nbrs[rng.random((2 * B, K)) < 0.3] = -1
    ntime = np.where(nbrs >= 0, rng.integers(0, 500, (2 * B, K)), 0).astype(np.int32)
    nfeat = np.where(nbrs[..., None] >= 0, rng.normal(size=(2 * B, K, DYG["edge_x_dim"])), 0.0)
    return node_x, src, dst, t, nbrs, ntime, nfeat.astype(np.float32)


def dyg_models(stream):
    j_enc = JDyGFormer(dropout=0.0, compute_bf16=True, bf16_stream=stream, **DYG)
    j_dec = JLinkPredictor(node_dim=16, hidden_dim=16)
    args = dyg_inputs(50)
    params = {"enc": perturbed(jinit(j_enc)(jax.random.PRNGKey(8), *(jnp.asarray(a) for a in args)),
                               8),
              "dec": jinit(j_dec)(jax.random.PRNGKey(9), jnp.zeros((1, 16)), jnp.zeros((1, 16)))}
    enc = DyGFormer(dropout=0.0, compute_bf16=True, bf16_stream=stream, **DYG)
    load_dygformer_params(params, enc, LinkPredictor(node_dim=16, hidden_dim=16))
    return j_enc, params, enc


@pytest.mark.parametrize("route", ["module", "kernel", "stream"])
def test_dygformer_compute_bf16_matches_jax(route):
    j_enc, params, enc = dyg_models(stream=route == "stream")
    sub = params["enc"]["params"]["transformers_0"]
    assert ("LayerNormBF16_0" in sub) == (route == "stream")
    args = dyg_inputs(11)
    pl = dygformer_pallas_layers(params["enc"], 2) if route == "kernel" else None
    want = source_apply(j_enc, params["enc"], *(jnp.asarray(a) for a in args), pallas_layers=pl)
    stack = enc.stack_weights() if route == "kernel" else None
    with torch.no_grad():
        got = enc(*(T(a) for a in args), stack=stack)
    for g, w in zip(got, want):
        assert_band(g, w)
    if route == "stream":
        with pytest.raises(ValueError, match="bf16_stream"):
            enc.stack_weights()


# ---------------------------------------------------------------------- #
# K1's bf16 rows, the precision policy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("D_", [172, 100, 173])
def test_k1_plain_route_copies_bf16_rows_exactly(D_):
    rng = np.random.default_rng(D_)
    N1, B_, E_, S_, K_ = 41, 12, 300, 64, 10
    ids = rng.integers(-1, N1 - 1, (N1, B_)).astype(np.int32)
    times = rng.integers(0, 100, (N1, B_)).astype(np.int32)
    eids = np.where(ids >= 0, rng.integers(0, E_, (N1, B_)), -1).astype(np.int32)
    wp = rng.integers(0, 3 * B_, N1).astype(np.int32)
    seeds = rng.integers(-2, N1 + 2, S_).astype(np.int32)
    qt = rng.integers(0, 120, S_).astype(np.int32)
    table = jnp.asarray(rng.normal(size=(E_, D_)).astype(np.float32)).astype(BF)
    tab = T(np.asarray(table.astype(jnp.float32))).to(torch.bfloat16)
    _, _, got_e, got_x = recency_eid_select(tuple(T(a) for a in (ids, times, eids, wp)),
                                            T(seeds), T(qt), K_, tab)
    assert got_x.dtype == torch.bfloat16 and got_x.shape == (S_, K_, D_)
    assert (got_e < 0).any() and (got_e >= 0).any()
    want = j_gather_edge_feats(table, jnp.asarray(got_e.numpy()))
    assert want.dtype == BF
    np.testing.assert_array_equal(got_x.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    assert torch.equal(gather_edge_feats(tab, got_e).view(torch.int16), got_x.view(torch.int16))
    with pytest.raises(ValueError, match="bfloat16"):
        recency_eid_select(tuple(T(a) for a in (ids, times, eids, wp)), T(seeds), T(qt), K_,
                           tab.half())


def test_resolve_bf16_keeps_the_jax_contract():
    for choice in ("on", "off", True, False, 1, 0):
        assert resolve_bf16(choice) is j_resolve_bf16(choice) or \
            resolve_bf16(choice) == j_resolve_bf16(choice)
    assert tpu_default_bf16() is False
    assert resolve_bf16("auto") is False and resolve_bf16(None) is False
    with pytest.raises(KeyError):
        resolve_bf16("maybe")
