"""The DyGFormer train path, piece by piece, against the JAX package on the CPU.

* ``TransformerEncoder`` (both attention layouts) and ``FusedSelfAttention``,
  deterministic, against the flax modules within 1e-5; ``fuse_attention_params``
  exactly.
* ``DyGFormer.forward`` on the module path (``stack=None``) against the JAX
  ``__call__`` without ``pallas_layers``, both layouts, within 1e-5.
* ``encode_pairs`` against the JAX ``encode_pairs`` and against two
  ``forward`` calls, within 1e-5.
* One ``train_core`` step with ``SGD(lr=1.0)`` against the JAX example's
  (``pairs="split"``) and ``bench.py``'s fused (``pairs="fused"``) train
  core with ``optax.sgd(1.0)``, so the weight change is the gradient, on the
  same hook-enriched batch: every leaf within 1e-5 (times its change where
  that exceeds 1: only Time2Vec's weight, which moves by tens; printed),
  the loss within 1e-6.
* Dropout: one (S, S) attention mask per call, shared by every sequence and
  head (flax's ``broadcast_dropout``), a whole-shape mask in the fused
  layout, kept values scaled by 1 / keep; the two pair calls of a step draw
  the same masks; eval is deterministic in either module mode and either
  stack.
* ``compute_bf16`` / ``bf16_stream`` build the JAX layers (dtypes, the
  ``LayerNormBF16_i`` names) and load the JAX tree (their numerics are held
  to flax in ``test_torch_bf16.py``); the stack weights of the fused layout
  raise ``ValueError``.

Sizes: 120 nodes, 800 edges, batch 100, K = 10, edge / time / channel dims
8 / 8 / 8 (D = 32), 2 layers, 2 heads, sequences of 16 per side, output 16,
made with numpy from a seed; weights from JAX's init (biases and LayerNorm
parameters moved off their init), loaded by ``load_dygformer_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.nn import DyGFormer as JDyGFormer
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.dygformer import FusedSelfAttention as JFusedAttn
from tgm_tpu.nn.encoder.dygformer import TransformerEncoder as JTransformer
from tgm_tpu.nn.encoder.dygformer import fuse_attention_params as j_fuse
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TGBNegativeEdgeSamplerHook
from tgm_tpu_torch.nn import (
    DyGFormer,
    FusedSelfAttention,
    LinkPredictor,
    MultiHeadDotProductAttention,
    TransformerEncoder,
)
from tgm_tpu_torch.train import (
    DeviceEdgeStream,
    build_dygformer_eval_core,
    build_dygformer_train_core,
    hook_epoch,
)
from tgm_tpu_torch.weights import (
    fuse_attention_params,
    load_dygformer_params,
    load_transformer_encoder_params,
)

N, E, BSIZE, K, EDGE_DIM, OUT, SEQ = 120, 800, 100, 10, 8, 16, 16
DYG = dict(node_feat_dim=1, edge_x_dim=EDGE_DIM, time_feat_dim=8, channel_embedding_dim=8,
           output_dim=OUT, patch_size=1, num_layers=2, num_heads=2,
           max_input_sequence_length=SEQ)
D = 4 * DYG["channel_embedding_dim"]


def perturbed(tree, seed):
    """The tree as numpy, with biases and LayerNorm parameters moved off their
    init, so that every parameter reaches the output."""
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


def inputs(seed, B, rows_per_edge=2):
    """Random encoder inputs: neighbour rows with PAD slots and repeated ids."""
    rng = np.random.default_rng(seed)
    R = rows_per_edge * B
    node_x = rng.normal(size=(N, 1)).astype(np.float32)
    seeds = [rng.integers(0, N, B).astype(np.int32) for _ in range(rows_per_edge)]
    t = rng.integers(500, 1000, B).astype(np.int32)
    nbrs = rng.integers(0, 12, (R, K)).astype(np.int32)
    nbrs[rng.random((R, K)) < 0.3] = -1
    ntime = np.where(nbrs >= 0, rng.integers(0, 500, (R, K)), 0).astype(np.int32)
    nfeat = np.where(nbrs[..., None] >= 0, rng.normal(size=(R, K, EDGE_DIM)), 0.0)
    return node_x, seeds, t, nbrs, ntime, nfeat.astype(np.float32)


def models(fused_attn=False, dropout=0.0, seed=0):
    """JAX encoder and decoder, their perturbed params, and the port's loaded copies."""
    j_enc = JDyGFormer(dropout=dropout, fused_attn=fused_attn, **DYG)
    j_dec = JLinkPredictor(node_dim=OUT, hidden_dim=OUT)
    node_x, (src, dst), t, nbrs, ntime, nfeat = inputs(50 + seed, 4)
    params = {
        "enc": perturbed(j_enc.init(jax.random.PRNGKey(seed), jnp.asarray(node_x), src, dst, t,
                                    nbrs, ntime, nfeat), seed),
        "dec": perturbed(j_dec.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, OUT)),
                                    jnp.zeros((1, OUT))), seed + 1),
    }
    enc = DyGFormer(dropout=dropout, fused_attn=fused_attn, **DYG)
    dec = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
    load_dygformer_params(params, enc, dec)
    return j_enc, j_dec, params, enc, dec


def assert_close(got, want, atol, what=""):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=atol,
                                   err_msg=what)


# ---------------------------------------------------------------------- #
# Modules, deterministic
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fused_attn", [False, True])
def test_transformer_encoder_matches_jax(fused_attn):
    x = np.random.default_rng(1).normal(size=(6, 12, D)).astype(np.float32)
    j_mod = JTransformer(attention_dim=D, num_heads=2, dropout=0.1, fused_attn=fused_attn)
    p = perturbed(j_mod.init(jax.random.PRNGKey(2), jnp.asarray(x)), 2)
    want = j_mod.apply(p, jnp.asarray(x), deterministic=True)
    mod = TransformerEncoder(D, 2, dropout=0.1, fused_attn=fused_attn)
    load_transformer_encoder_params(p["params"], mod)
    assert isinstance(mod.attn, FusedSelfAttention if fused_attn else MultiHeadDotProductAttention)
    got = mod(torch.from_numpy(x))  # no generator: no dropout, whatever the mode
    assert_close([got], [want], 1e-5)
    assert float(np.abs(np.asarray(want) - x).max()) > 0.1  # the layer changed its input


def test_fused_self_attention_matches_jax():
    x = np.random.default_rng(3).normal(size=(5, 9, D)).astype(np.float32)
    j_mod = JFusedAttn(dim=D, num_heads=4)
    p = perturbed(j_mod.init(jax.random.PRNGKey(4), jnp.asarray(x)), 4)["params"]
    mod = FusedSelfAttention(D, 4)
    with torch.no_grad():
        for name in ("qkv", "out"):
            getattr(mod, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            getattr(mod, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
    want = j_mod.apply({"params": p}, jnp.asarray(x), deterministic=True)
    assert_close([mod(torch.from_numpy(x))], [want], 1e-5)


def test_fuse_attention_params_matches_jax():
    _, _, params, enc, _ = models()
    mha = params["enc"]["params"]["transformers_1"]["MultiHeadDotProductAttention_0"]
    got, want = fuse_attention_params(mha), j_fuse(jax.tree_util.tree_map(jnp.asarray, mha))
    for part in ("qkv", "out"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[part][leaf], np.asarray(want[part][leaf]))
    # The fused layout loaded from the converted tree computes what the flax-MHA one does.
    fused = DyGFormer(fused_attn=True, **DYG)
    tree = jax.tree_util.tree_map(lambda a: a, params)
    for i in range(2):
        sub = tree["enc"]["params"][f"transformers_{i}"]
        sub["FusedSelfAttention_0"] = fuse_attention_params(
            sub.pop("MultiHeadDotProductAttention_0"))
    load_dygformer_params(tree, fused, LinkPredictor(node_dim=OUT, hidden_dim=OUT))
    node_x, (src, dst), t, nbrs, ntime, nfeat = inputs(5, 8)
    args = [torch.from_numpy(a) for a in (node_x, src, dst, t, nbrs, ntime, nfeat)]
    assert_close(fused(*args), [z.detach().numpy() for z in enc(*args)], 1e-5)


@pytest.mark.parametrize("fused_attn", [False, True])
def test_forward_module_path_matches_jax(fused_attn):
    j_enc, _, params, enc, _ = models(fused_attn=fused_attn)
    node_x, (src, dst), t, nbrs, ntime, nfeat = inputs(6, 8)
    want = j_enc.apply(params["enc"], jnp.asarray(node_x), src, dst, t, nbrs, ntime, nfeat)
    got = enc(*(torch.from_numpy(a) for a in (node_x, src, dst, t, nbrs, ntime, nfeat)))
    assert_close(got, want, 1e-5)
    assert got[0].requires_grad  # the module path is differentiable


def test_encode_pairs_matches_jax_and_two_forwards():
    j_enc, _, params, enc, _ = models()
    node_x, (src, dst, neg), t, nbrs, ntime, nfeat = inputs(7, 8, rows_per_edge=3)
    want = j_enc.apply(params["enc"], jnp.asarray(node_x), src, dst, neg, t, nbrs, ntime, nfeat,
                       method=JDyGFormer.encode_pairs)
    T = lambda a: torch.from_numpy(a)
    got = enc.encode_pairs(*(T(a) for a in (node_x, src, dst, neg, t, nbrs, ntime, nfeat)))
    assert_close(got, want, 1e-5, "encode_pairs against JAX")
    B = src.shape[0]
    neg_rows = lambda a: T(np.concatenate([a[:B], a[2 * B:]]))
    pos = enc(T(node_x), T(src), T(dst), T(t), T(nbrs[:2 * B]), T(ntime[:2 * B]),
              T(nfeat[:2 * B]))
    negp = enc(T(node_x), T(src), T(neg), T(t), neg_rows(nbrs), neg_rows(ntime), neg_rows(nfeat))
    assert_close(got, [z.detach().numpy() for z in (*pos, *negp)], 1e-5, "two forwards")
    # The two src embeddings differ: the co-occurrence channel depends on the pair.
    assert float((got[0] - got[2]).detach().abs().max()) > 1e-4


# ---------------------------------------------------------------------- #
# One train step
# ---------------------------------------------------------------------- #
def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    node_x = rng.normal(size=(N, 1)).astype(np.float32)
    return src, dst, t, edge_x, node_x, rng


def jax_enriched_batch(src, dst, t, edge_x, index):
    """Batch ``index`` (modulo the batch count) of the train split through the
    JAX random-negative and feature-layout recency hooks."""
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    train, _, _ = data.split()
    dg = JDGraph(train)
    hm = JHookManager(keys=["train"])
    hm.register("train", JRandomNeg(low=0, high=N))
    hm.register_shared(JRecency(N, [K], ["edge_src", "edge_dst", "neg"],
                                ["edge_time", "edge_time", "neg_time"], edge_dim=EDGE_DIM))
    stream = JStream(dg, BSIZE)
    fn, states = hm.as_transform("train", dg)
    fn = jax.jit(fn)
    for i in range(index % stream.num_batches + 1):
        states, batch = fn(states, stream.batch_at(i))
    return batch


def port_batch(jb):
    up = lambda x: torch.from_numpy(np.array(x))
    return DGBatch(up(jb.edge_src), up(jb.edge_dst), up(jb.edge_time), up(jb.edge_valid),
                   edge_x=up(jb.edge_x), neg=up(jb.neg), seed_nids=[up(jb.seed_nids[0])],
                   nbr_nids=[up(jb.nbr_nids[0])], nbr_edge_time=[up(jb.nbr_edge_time[0])],
                   nbr_edge_x=[up(jb.nbr_edge_x[0])])


def jax_train_core(encoder, decoder, opt, node_x, pairs):
    """The JAX example's ``train_core`` (split) or ``bench.py``'s (fused)."""

    def train_core(carry, batch):
        params, opt_state = carry
        B = batch.edge_src.shape[0]
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]

        def loss_fn(p):
            if pairs == "fused":
                zs, zd, zs2, zn = encoder.apply(p["enc"], node_x, batch.edge_src, batch.edge_dst,
                                                batch.neg, batch.edge_time, nbr, nt, nx,
                                                method=JDyGFormer.encode_pairs)
            else:
                cat = lambda a, lo: jnp.concatenate([a[:B], a[lo:lo + B]])
                zs, zd = encoder.apply(p["enc"], node_x, batch.edge_src, batch.edge_dst,
                                       batch.edge_time, cat(nbr, B), cat(nt, B), cat(nx, B))
                zs2, zn = encoder.apply(p["enc"], node_x, batch.edge_src, batch.neg,
                                        batch.edge_time, cat(nbr, 2 * B), cat(nt, 2 * B),
                                        cat(nx, 2 * B))
            pos = decoder.apply(p["dec"], zs, zd)
            neg = decoder.apply(p["dec"], zs2, zn)
            m = batch.edge_valid.astype(pos.dtype)
            d = jnp.maximum(m.sum(), 1.0)
            return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
                    + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)) * m)
                    ) / d

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state), loss

    return train_core


@pytest.mark.parametrize("pairs", ["split", "fused"])
def test_one_train_step_matches_jax(pairs):
    src, dst, t, edge_x, node_x, _ = make_stream(0)
    jb = jax_enriched_batch(src, dst, t, edge_x, -1)  # the padded tail batch
    assert not np.asarray(jb.edge_valid).all() and np.asarray(jb.edge_valid).any()
    j_enc, j_dec, params, enc, dec = models()
    opt = optax.sgd(1.0)
    j_core = jax_train_core(j_enc, j_dec, opt, jnp.asarray(node_x), pairs)
    (j_params, _), j_loss = jax.jit(j_core)((params, opt.init(params)), jb)

    t_opt = torch.optim.SGD([*enc.parameters(), *dec.parameters()], lr=1.0)
    core = build_dygformer_train_core(enc, dec, t_opt, torch.from_numpy(node_x), pairs=pairs)
    (gen,), loss = core((None,), port_batch(jb))
    assert gen is None and not loss.requires_grad
    assert abs(float(loss) - float(j_loss)) <= 1e-6, (float(loss), float(j_loss))

    want_enc = DyGFormer(**DYG)
    want_dec = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
    load_dygformer_params(j_params, want_enc, want_dec)
    before = DyGFormer(**DYG)
    load_dygformer_params(params, before, LinkPredictor(node_dim=OUT, hidden_dim=OUT))
    init = dict(before.named_parameters())
    largest = (0.0, "", 0.0)
    for m, w, name in ((enc, want_enc, "enc"), (dec, want_dec, "dec")):
        for (k, p), (_, q) in zip(m.named_parameters(), w.named_parameters()):
            diff = float((p - q).detach().abs().max())
            # Time2Vec's weight moves by tens (its gradient sums gaps up to
            # 1,600 over every slot): fp32 sums in two orders differ in
            # proportion to it.
            step = float((q - init[k]).detach().abs().max()) if name == "enc" else 0.0
            assert diff <= 1e-5 * max(1.0, step), (name, k, diff, step)
            largest = max(largest, (step, k, diff))
    print(f"{pairs}: largest step {largest[0]:.3g} ({largest[1]}, diff {largest[2]:.3g}), "
          f"loss diff {abs(float(loss) - float(j_loss)):.3g}")
    # Every leaf moved: the comparison is not of unchanged weights.
    moved = jax.tree_util.tree_map(lambda a, b: bool(np.any(np.asarray(a) != np.asarray(b))),
                                   j_params, params)
    assert all(jax.tree_util.tree_leaves(moved))


def test_train_core_rejects_an_unknown_pair_mode():
    _, _, _, enc, dec = models()
    opt = torch.optim.SGD([*enc.parameters()], lr=1.0)
    with pytest.raises(ValueError, match="pairs"):
        build_dygformer_train_core(enc, dec, opt, torch.zeros((N, 1)), pairs="joint")


# ---------------------------------------------------------------------- #
# Dropout
# ---------------------------------------------------------------------- #
def test_attention_dropout_is_one_mask_per_call():
    """flax MHA's dropout: one (S, S) keep mask, drawn from the generator,
    shared by every sequence and head, the kept weights scaled by 1 / keep."""
    S, p = 7, 0.5
    x = np.random.default_rng(8).normal(size=(1, S, D)).astype(np.float32)
    h = torch.from_numpy(np.repeat(x, 4, axis=0))  # four equal sequences
    mod = MultiHeadDotProductAttention(D, 2, dropout=p)
    out = mod(h, torch.Generator().manual_seed(3))
    torch.testing.assert_close(out, out[:1].expand_as(out), rtol=0, atol=0)
    keep = torch.rand((S, S), generator=torch.Generator().manual_seed(3)) < 1 - p
    assert 0 < int(keep.sum()) < S * S
    with torch.no_grad():
        dh = D // 2
        q = mod.query(h).reshape(4, S, 2, dh) / dh ** 0.5
        k = mod.key(h).reshape(4, S, 2, dh)
        v = mod.value(h).reshape(4, S, 2, dh)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        a = torch.where(keep, a / (1 - p), 0.0)  # the same mask for every sequence and head
        want = mod.out(torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(4, S, D))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    plain = mod(h)
    assert float((out - plain).detach().abs().max()) > 1e-3  # the mask was applied
    # The fused layout draws a mask of the weights' whole (B, H, S, S) shape.
    fmod = FusedSelfAttention(D, 2, dropout=p)
    fout = fmod(h, torch.Generator().manual_seed(3))
    assert float((fout[0] - fout[1]).detach().abs().max()) > 1e-4


def test_pair_calls_share_dropout_masks():
    """With the negative equal to the destination (id and neighbour rows), the
    two pair calls of a split step see equal inputs: with shared masks they
    give equal embeddings, at dropout 0.5."""
    src, dst, t, edge_x, node_x, _ = make_stream(1)
    b = port_batch(jax_enriched_batch(src, dst, t, edge_x, 2))
    B = BSIZE
    b.neg = b.edge_dst.clone()
    for name in ("nbr_nids", "nbr_edge_time", "nbr_edge_x"):
        x = getattr(b, name)[0]
        x[2 * B:] = x[B:2 * B]
    _, _, _, enc, dec = models(dropout=0.5)
    seen = []

    def recording_decoder(z_a, z_b):
        seen.append((z_a.detach().clone(), z_b.detach().clone()))
        return dec(z_a, z_b)

    opt = torch.optim.SGD([*enc.parameters(), *dec.parameters()], lr=0.0)
    core = build_dygformer_train_core(enc, recording_decoder, opt, torch.from_numpy(node_x))
    gen = torch.Generator().manual_seed(5)
    core((gen,), b)
    (zs, zd), (zs2, zn) = seen
    torch.testing.assert_close(zs, zs2, rtol=0, atol=0)
    torch.testing.assert_close(zd, zn, rtol=0, atol=0)
    core((None,), b)  # no generator: no dropout
    assert float((seen[2][0] - zs).abs().max()) > 1e-3
    core((gen,), b)  # the generator moved on: other masks
    assert float((seen[4][0] - zs).abs().max()) > 1e-3


@pytest.mark.parametrize("stack", ["module", "kernel"])
def test_eval_is_deterministic_in_either_module_mode(stack):
    src, dst, t, edge_x, node_x, rng = make_stream(2)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, _ = data.split()
    dg = DGraph(val)
    cands = rng.integers(0, N, (dg.num_edge_events, 4))
    _, _, _, enc, dec = models(dropout=0.5)
    sums = {}
    for mode in ("train", "eval"):
        enc.train(mode == "train")
        dec.train(mode == "train")
        hm = HookManager(keys=["val"])
        hm.register("val", TGBNegativeEdgeSamplerHook(cands, device="cpu", seed=1))
        hm.register_shared(RecencyNeighborHook(N, [K], ["edge_src", "edge_dst", "neg"],
                                               ["edge_time", "edge_time", "neg_time"],
                                               edge_dim=EDGE_DIM, device="cpu"))
        core = build_dygformer_eval_core(enc, dec, torch.from_numpy(node_x), N, stack=stack)
        epoch, states = hook_epoch(DeviceEdgeStream(dg, BSIZE, device="cpu"), hm, "val", dg,
                                   core)
        _, _, (s, c) = epoch(None, states)
        sums[mode] = s
    torch.testing.assert_close(sums["train"], sums["eval"], rtol=0, atol=0)
    assert float(sums["eval"].sum()) > 0
    with pytest.raises(ValueError, match="stack"):
        build_dygformer_eval_core(enc, dec, torch.from_numpy(node_x), N, stack="pallas")


# ---------------------------------------------------------------------- #
# Options that are not ported, and the layouts the kernel takes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("flag", ["compute_bf16", "bf16_stream"])
def test_bf16_options_build_the_jax_layers(flag):
    """``bf16_stream`` acts only with ``compute_bf16``, as in JAX."""
    enc = DyGFormer(**DYG, **{flag: True})
    j_enc = JDyGFormer(**DYG, **{flag: True})
    node_x, (src, dst), t, nbrs, ntime, nfeat = inputs(8, 4)
    tree = jax.eval_shape(j_enc.init, jax.random.PRNGKey(0), jnp.asarray(node_x), src, dst, t,
                          nbrs, ntime, nfeat)["params"]
    stream = "LayerNormBF16_0" in tree["transformers_0"]
    assert stream is False and not any(layer.bf16_stream for layer in enc.transformers)
    on = flag == "compute_bf16"
    assert (enc.compute_dtype == torch.bfloat16) == on
    assert all((layer.dtype == torch.bfloat16) == on for layer in enc.transformers)
    both = DyGFormer(**DYG, compute_bf16=True, bf16_stream=True)
    assert all(layer.bf16_stream for layer in both.transformers)


def test_stack_weights_need_the_flax_mha_layout():
    with pytest.raises(ValueError, match="flax-MHA"):
        DyGFormer(fused_attn=True, **DYG).stack_weights()
    _, _, _, enc, _ = models(dropout=0.5)
    node_x, (src, dst), t, nbrs, ntime, nfeat = inputs(9, 4)
    args = [torch.from_numpy(a) for a in (node_x, src, dst, t, nbrs, ntime, nfeat)]
    with pytest.raises(ValueError, match="generator"):
        enc(*args, deterministic=False)
    with pytest.raises(ValueError, match="no dropout"):
        enc(*args, deterministic=False, stack=enc.stack_weights(),
            generator=torch.Generator().manual_seed(0))
