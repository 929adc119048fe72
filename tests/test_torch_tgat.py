"""TGAT's modules and one train step, against the JAX package on the CPU.

* ``TemporalAttention`` against the flax module (both score layouts), with
  an out_dim that needs the zero pad (node dim 1 + time dim 4 = 5, 2 heads),
  rows with no valid neighbour and the pre-concatenated ``nbr_kv_x``
  branch: within 1e-5.
* ``TGAT`` (2 layers, 2 hops) against the flax module, with and without the
  deepest hop's K/V rows pre-concatenated: within 1e-5.
* One train step of the example's ``train_core`` (no dropout) on a batch
  enriched by the JAX two-hop recency hook: the loss within 1e-6 and every
  leaf's gradient within 1e-5 of ``jax.grad``'s, relative to the leaf's
  largest gradient (printed).
* Dropout: each ``TemporalAttention`` call draws an elementwise mask of
  the (B, H, K) weights, then one of the (B, out_dim) output, from the
  caller's generator, kept values scaled by 1 / keep (the masks are rebuilt
  here); no generator, no dropout, in either module mode.
* ``Time2Vec`` at gaps of millions of seconds against JAX's within 1e-6
  (ROADMAP.md fault 9).
* An unknown score layout and a zero width raise; ``kv_bf16=True`` builds
  (its numerics are held to flax in ``test_torch_bf16.py``).

Sizes: 12 to 120 nodes, K <= 4 a hop, edge / time / embed dims 3-8 / 4-8 /
6-16, made with numpy from a seed; weights from JAX's init with biases and
LayerNorm parameters moved off their init, loaded by ``load_tgat_params``.
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
from tgm_tpu.nn import TGAT as JTGAT
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.modules.attention import TemporalAttention as JAttention
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.nn import TGAT, LinkPredictor, TemporalAttention
from tgm_tpu_torch.train import build_tgat_train_core
from tgm_tpu_torch.weights import load_tgat_params

H, NODE, EDGE, TIME = 2, 1, 3, 4


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


def load_attention(p, mod):
    """A flax TemporalAttention subtree into the port's module."""
    with torch.no_grad():
        for name in ("W_Q", "W_KV", "W_O"):
            lin = getattr(mod, name)
            lin.weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            if lin.bias is not None:
                lin.bias.copy_(torch.from_numpy(p[name]["bias"]))
        mod.layer_norm.weight.copy_(torch.from_numpy(p["layer_norm"]["scale"]))
        mod.layer_norm.bias.copy_(torch.from_numpy(p["layer_norm"]["bias"]))


def attention_inputs(seed, B=6, K=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mask = rng.random((B, K)) < 0.6
    mask[0] = False  # a row with no valid neighbour
    mask[1] = True
    return f(B, NODE), f(B, TIME), f(B, K, EDGE), f(B, K, NODE), f(B, K, TIME), mask


@pytest.mark.parametrize("fused_kv", [False, True])
@pytest.mark.parametrize("layout", ["kmajor", "lanes"])
def test_temporal_attention_matches_flax(layout, fused_kv):
    x, tf, ef, nf, ntf, mask = attention_inputs(1)
    j_mod = JAttention(n_heads=H, node_dim=NODE, edge_dim=EDGE, time_dim=TIME,
                       score_layout=layout)
    p = perturbed(j_mod.init(jax.random.PRNGKey(0), x, tf, ef, nf, ntf, mask), 0)
    kv = np.concatenate([nf, ef], axis=-1) if fused_kv else None
    want = j_mod.apply(p, x, tf, None if fused_kv else ef, None if fused_kv else nf, ntf, mask,
                       kv_node_edge_feat=kv)
    mod = TemporalAttention(H, NODE, EDGE, TIME, score_layout=layout)
    assert (mod.pad_dim, mod.out_dim) == (1, 6)  # 1 + 4 padded up to the 2 heads
    load_attention(p["params"], mod)
    T = lambda a: None if a is None else torch.from_numpy(a)
    got = mod(T(x), T(tf), None if fused_kv else T(ef), None if fused_kv else T(nf), T(ntf),
              T(mask), kv_node_edge_feat=T(kv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # The empty row softmaxed uniformly over its padded slots: not the zero row.
    assert float(np.abs(np.asarray(want)[0]).max()) > 0.1


def tgat_inputs(seed, N=12, S=4, ks=(3, 2), edge=EDGE):
    """Two hops of neighbour rows with PAD slots, empty rows and PAD seeds."""
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
        nb[rng.random((s, k)) < 0.35] = -1
        nb[0] = -1
        nbrs.append(nb)
        nt.append(np.where(nb >= 0, rng.integers(0, 100, (s, k)), 0).astype(np.int32))
        nx.append(np.where(nb[..., None] >= 0, rng.normal(size=(s, k, edge)), 0.0)
                  .astype(np.float32))
    return node_x, seeds, times, nbrs, nx, nt


def tgat_models(embed=6, time=TIME, edge=EDGE, dropout=0.1, seed=0):
    j_enc = JTGAT(node_dim=NODE, edge_dim=edge, time_dim=time, embed_dim=embed, num_layers=2,
                  n_heads=H, dropout=dropout)
    j_dec = JLinkPredictor(node_dim=embed)
    node_x, *hops = tgat_inputs(50 + seed, edge=edge)
    params = {
        "enc": perturbed(j_enc.init(jax.random.PRNGKey(seed), jnp.asarray(node_x), *hops), seed),
        "dec": perturbed(j_dec.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, embed)),
                                    jnp.zeros((1, embed))), seed + 1),
    }
    enc = TGAT(NODE, edge, time, embed, 2, n_heads=H, dropout=dropout)
    dec = LinkPredictor(node_dim=embed)
    load_tgat_params(params, enc, dec)
    return j_enc, j_dec, params, enc, dec


@pytest.mark.parametrize("fused_kv", [False, True])
def test_tgat_matches_flax(fused_kv):
    j_enc, _, params, enc, _ = tgat_models()
    node_x, seeds, times, nbrs, nx, nt = tgat_inputs(3)
    kv = None
    if fused_kv:
        # The deepest hop's [node ‖ edge] rows, PAD slots holding the wrapped
        # last node row and zero edge features.
        ids = nbrs[1]
        kv = [None, np.concatenate([node_x[np.where(ids < 0, ids + len(node_x), ids)], nx[1]],
                                   axis=-1)]
    want = j_enc.apply(params["enc"], jnp.asarray(node_x), seeds, times, nbrs, nx, nt,
                       nbr_kv_x=kv)
    L = lambda xs: [None if a is None else torch.from_numpy(a) for a in xs]
    got = enc(torch.from_numpy(node_x), L(seeds), L(times), L(nbrs), L(nx), L(nt),
              nbr_kv_x=None if kv is None else L(kv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert got.shape == (4, 6) and got.requires_grad


# ---------------------------------------------------------------------- #
# One train step
# ---------------------------------------------------------------------- #
N, E, BSIZE, KS, EMB, T2, EDGE2 = 120, 800, 100, [4, 3], 16, 8, 8


def jax_enriched_batch(index, seed=0):
    """Batch ``index`` of the train split through the JAX random-negative and
    two-hop eid-layout recency hooks, and the node features."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))
    edge_x = rng.normal(size=(E, EDGE2)).astype(np.float32)
    node_x = rng.normal(size=(N, NODE)).astype(np.float32)
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    train, _, _ = data.split()
    dg = JDGraph(train)
    hm = JHookManager(keys=["train"])
    hm.register("train", JRandomNeg(low=0, high=N))
    hm.register_shared(JRecency(N, KS, ["edge_src", "edge_dst", "neg"],
                                ["edge_time", "edge_time", "neg_time"], edge_dim=EDGE2,
                                edge_x_full=data.edge_x))
    stream = JStream(dg, BSIZE)
    fn, states = hm.as_transform("train", dg)
    fn = jax.jit(fn)
    for i in range(index % stream.num_batches + 1):
        states, batch = fn(states, stream.batch_at(i))
    return batch, node_x


def port_batch(jb):
    up = lambda x: torch.from_numpy(np.array(x))
    hops = {name: [up(a) for a in getattr(jb, name)] for name in
            ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x")}
    return DGBatch(up(jb.edge_src), up(jb.edge_dst), up(jb.edge_time), up(jb.edge_valid),
                   neg=up(jb.neg), **hops)


def jax_loss_fn(encoder, decoder, node_x, batch):
    """The JAX example's ``train_core`` loss (examples/linkproppred/tgat.py:161-180)."""

    def loss_fn(p):
        B = batch.edge_src.shape[0]
        z = encoder.apply(p["enc"], node_x, batch.seed_nids, batch.seed_times, batch.nbr_nids,
                          batch.nbr_edge_x, batch.nbr_edge_time)
        pos = decoder.apply(p["dec"], z[:B], z[B:2 * B])
        neg = decoder.apply(p["dec"], z[:B], z[2 * B:3 * B])

        def bce(logits, target, mask):
            loss = optax.sigmoid_binary_cross_entropy(logits, target)
            w = mask.astype(loss.dtype)
            return jnp.sum(loss * w) / jnp.maximum(jnp.sum(w), 1.0)

        m = batch.edge_valid
        return bce(pos, jnp.ones_like(pos), m) + bce(neg, jnp.zeros_like(neg), m)

    return loss_fn


def test_one_train_step_gradients_match_jax():
    jb, node_x = jax_enriched_batch(-1)  # the padded tail batch
    assert not np.asarray(jb.edge_valid).all() and np.asarray(jb.edge_valid).any()
    assert len(jb.nbr_nids) == 2 and (np.asarray(jb.nbr_nids[1]) >= 0).any()
    j_enc, j_dec, params, enc, dec = tgat_models(EMB, T2, EDGE2, dropout=0.1)
    loss_fn = jax_loss_fn(j_enc, j_dec, jnp.asarray(node_x), jb)
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    opt = torch.optim.SGD([*enc.parameters(), *dec.parameters()], lr=1.0)
    core = build_tgat_train_core(enc, dec, opt, torch.from_numpy(node_x))
    loss = core.loss_and_grad(port_batch(jb), None)  # no generator: no dropout
    assert not loss.requires_grad
    assert abs(float(loss) - float(j_loss)) <= 1e-6, (float(loss), float(j_loss))

    # The JAX gradients in the port's layout (Dense kernels transposed).
    want_enc = TGAT(NODE, EDGE2, T2, EMB, 2, n_heads=H)
    want_dec = LinkPredictor(node_dim=EMB)
    load_tgat_params(jax.tree_util.tree_map(np.asarray, j_grads), want_enc, want_dec)
    worst = (0.0, "")
    for m, w in ((enc, want_enc), (dec, want_dec)):
        for (name, p), (_, g) in zip(m.named_parameters(), w.named_parameters()):
            g = g.detach()
            scale = float(g.abs().max())
            rel = float((p.grad - g).abs().max()) / max(scale, 1e-12)
            assert scale > 0, name  # every leaf gets a gradient
            assert rel <= 1e-5, (name, rel, scale)
            worst = max(worst, (rel, name))
    print(f"loss diff {abs(float(loss) - float(j_loss)):.3g}; largest relative gradient "
          f"difference {worst[0]:.3g} ({worst[1]})")
    opt.step()


# ---------------------------------------------------------------------- #
# Dropout
# ---------------------------------------------------------------------- #
def test_attention_dropout_masks_come_from_the_generator():
    """Two elementwise masks a call, (B, H, K) weights then (B, out_dim)
    output, from the caller's generator, kept values scaled by 1 / keep."""
    x, tf, ef, nf, ntf, mask = attention_inputs(2, B=5, K=3)
    p = 0.5
    mod = TemporalAttention(H, NODE, EDGE, TIME, dropout=p)
    args = [torch.from_numpy(a) for a in (x, tf, ef, nf, ntf, mask)]
    out = mod(*args, generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    B, K, O, dh = 5, 3, mod.out_dim, mod.head_dim
    keep_w = torch.rand((B, H, K), generator=gen) < 1 - p
    keep_o = torch.rand((B, O), generator=gen) < 1 - p
    assert 0 < int(keep_w.sum()) < keep_w.numel() and 0 < int(keep_o.sum()) < keep_o.numel()
    with torch.no_grad():
        xt, tft, eft, nft, ntft, m = args
        R = torch.cat([torch.nn.functional.pad(xt, (0, mod.pad_dim)), tft], -1)
        q = mod.W_Q(R).reshape(B, H, dh)
        Z = mod.W_KV(torch.cat([nft, eft, ntft], -1))
        k, v = Z[..., :O].reshape(B, K, H, dh), Z[..., O:].reshape(B, K, H, dh)
        a = torch.einsum("bhd,bkhd->bhk", q, k) * dh ** -0.5
        a = torch.softmax(torch.where(m[:, None, :], a, -1e10), -1)
        a = torch.where(keep_w, a / (1 - p), 0.0)
        o = mod.W_O(torch.einsum("bhk,bkhd->bhd", a, v).reshape(B, O))
        want = mod.layer_norm(torch.where(keep_o, o / (1 - p), 0.0) + R)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    plain = mod(*args)
    assert float((out - plain).abs().max()) > 1e-3  # the masks were applied


def test_tgat_dropout_only_with_a_generator():
    _, _, _, enc, _ = tgat_models(dropout=0.5)
    node_x, *hops = tgat_inputs(4)
    L = lambda xs: [torch.from_numpy(a) for a in xs]
    args = (torch.from_numpy(node_x), *(L(h) for h in hops))
    outs = {}
    for mode in (True, False):
        enc.train(mode)
        outs[mode] = enc(*args)
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)  # deterministic
    a = enc(*args, generator=torch.Generator().manual_seed(1))
    b = enc(*args, generator=torch.Generator().manual_seed(1))
    c = enc(*args, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - outs[False]).abs().max()) > 1e-3 and float((a - c).abs().max()) > 1e-3


def test_time2vec_matches_jax_at_large_gaps():
    """The phase ``dt * w + b`` rounded once, as the jitted JAX package rounds
    it: at gaps of millions of seconds one ulp of the phase is a quarter of
    a radian, so a phase rounded twice would move ``cos`` by up to 0.25."""
    from tgm_tpu.nn.modules.time_encoding import Time2Vec as JTime2Vec
    from tgm_tpu_torch.nn import Time2Vec

    rng = np.random.default_rng(12)
    T = 100
    w = ((1 / 10 ** np.linspace(0, 9, T)) * (1 + 1e-3 * rng.normal(size=T))).astype(np.float32)
    b = (0.01 * rng.normal(size=T)).astype(np.float32)
    dt = rng.integers(0, 2_700_000, (64, 20)).astype(np.int32)
    params = {"params": {"w": w[None], "b": b}}
    want = jax.jit(lambda p, x: JTime2Vec(T).apply(p, x))(params, jnp.asarray(dt))
    mod = Time2Vec(T)
    with torch.no_grad():
        mod.w.weight.copy_(torch.from_numpy(w[:, None].copy()))
        mod.w.bias.copy_(torch.from_numpy(b))
    got = mod(torch.from_numpy(dt)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    # The phase rounded twice (product, then sum) is off.
    twice = torch.cos(torch.from_numpy(dt).float()[..., None] * torch.from_numpy(w)
                      + torch.from_numpy(b))
    assert float(np.abs(twice.numpy() - np.asarray(want)).max()) > 1e-2


def test_unported_options_raise():
    assert TemporalAttention(H, NODE, EDGE, TIME, kv_bf16=True).kv_bf16
    assert all(a.kv_bf16 for a in TGAT(NODE, EDGE, TIME, 6, 2, kv_bf16=True).attn)
    with pytest.raises(ValueError, match="score_layout"):
        TemporalAttention(H, NODE, EDGE, TIME, score_layout="lanesv")
    with pytest.raises(ValueError, match="> 0"):
        TemporalAttention(H, NODE, 0, TIME)
