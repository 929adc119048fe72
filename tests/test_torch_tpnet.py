"""TPNet's modules against the JAX package, inputs made with numpy from a seed.

* ``rp_init_state``: the identity base exact, the random base's (N+1)-row
  layout and its scale; ``rp_update`` within fp32 1e-5 (projections and
  ``now_time``) over a chain of batches with an invalid row, an all-invalid
  batch, duplicate rows and self loops, at times past 2^24; an empty batch
  raises in both; the input state is left as it was.
* ``RandomProjectionModule`` with 1-3 layers (and ``concat_src_dst=False``),
  padded and out-of-range ids included, within 1e-5 * max of flax's on the
  same weights and state.
* ``TPNet`` with and without random projections, with one and two mixer
  blocks: within 1e-5 * max |z| on the seeds with a neighbour, and within
  1e-4 on a seed whose neighbour slots are all padding. That seed feeds the
  mixers rows whose variance lies far below the LayerNorms' eps (1e-5),
  where a LayerNorm scales the roundings of x - E[x] by up to 1/sqrt(eps),
  about 316: the port's fused LayerNorm (two-pass variance) and flax's
  (E[x²] - E[x]²) end up 2e-5 * max apart there.
* Dropout comes from the generator passed, only when the call is not
  deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.nn import RandomProjectionModule as JRP
from tgm_tpu.nn import TPNet as JTPNet
from tgm_tpu.nn.encoder.tpnet import rp_init_state as j_rp_init_state
from tgm_tpu.nn.encoder.tpnet import rp_update as j_rp_update
from tgm_tpu_torch.nn import (
    LinkPredictor,
    RandomProjectionModule,
    RandomProjectionState,
    TPNet,
    rp_init_state,
    rp_update,
)
from tgm_tpu_torch.weights import load_tpnet_params, rp_state_from_numpy

N, DIM, LAMBDA = 11, 8, 1e-4
T0 = 2 ** 25  # times past 2^24


def j_to_p(state):
    return rp_state_from_numpy(state.projections, state.now_time)


def close(got, want, tol=1e-5, rel=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0) if rel else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_rp_init_state():
    j = j_rp_init_state(N, 2, DIM, 5.0, True, jax.random.PRNGKey(0))
    p = rp_init_state(N, 2, DIM, 5.0, True)
    np.testing.assert_array_equal(p.projections.numpy(), np.asarray(j.projections))
    assert float(p.now_time) == float(j.now_time) == 5.0
    g = torch.Generator().manual_seed(0)
    r = rp_init_state(500, 2, 64, 0.0, False, g)
    assert r.projections.shape == (3, 501, 64)  # the dump row is drawn too
    assert float(r.projections[0, 500].abs().sum()) > 0
    assert torch.all(r.projections[1:] == 0)
    assert abs(float(r.projections[0].std()) * 8 - 1.0) < 0.02  # N(0, 1) / sqrt(64)
    again = rp_init_state(500, 2, 64, 0.0, False, torch.Generator().manual_seed(0))
    assert torch.equal(again.projections, r.projections)


def update_chain(seed=0):
    """Batches of (src, dst, time, valid): an invalid row, an all-invalid
    batch, duplicate rows and self loops."""
    rng = np.random.default_rng(seed)
    out = []
    t = T0
    for b in range(6):
        B = 7
        src = rng.integers(0, N, B).astype(np.int32)
        dst = rng.integers(0, N, B).astype(np.int32)
        t = t + rng.integers(0, 3000)
        times = np.sort(t + rng.integers(0, 500, B)).astype(np.int32)
        valid = np.ones(B, bool)
        if b == 1:
            valid[3] = False
            src[3] = dst[3] = -1
        if b == 2:
            valid[:] = False  # nothing to add: only the decay (to now_time)
        if b == 3:
            src[:4] = 2
            dst[:2] = 2  # self loops
            dst[2:4] = 5  # a duplicated (2, 5) edge
        out.append((src, dst, times, valid))
    return out


@pytest.mark.parametrize("use_matrix", [False, True])
def test_rp_update_matches_jax(use_matrix):
    dim = N + 1 if use_matrix else DIM
    j = j_rp_init_state(N, 2, dim, float(T0 - 100), use_matrix, jax.random.PRNGKey(1))
    p = j_to_p(j)
    upd = jax.jit(j_rp_update, static_argnums=(5,))
    for b, (src, dst, t, valid) in enumerate(update_chain()):
        before = p.projections.clone()
        j = upd(j, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(t), jnp.asarray(valid), LAMBDA)
        q = rp_update(p, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(t),
                      torch.from_numpy(valid), LAMBDA)
        assert torch.equal(p.projections, before)  # the input state is left as it was
        p = q
        close(p.projections, j.projections)
        np.testing.assert_allclose(float(p.now_time), float(j.now_time), rtol=1e-7)
        assert float(p.projections[1:, N].abs().max()) == 0  # the dump rows above layer 0
    assert float(p.projections[2].abs().max()) > 0  # two hops propagated


def test_rp_update_without_a_mask_and_on_an_empty_batch():
    j = j_rp_init_state(N, 1, DIM, 0.0, False, jax.random.PRNGKey(2))
    p = j_to_p(j)
    src, dst = np.array([0, 4], np.int32), np.array([4, 0], np.int32)
    t = np.array([10, 12], np.int32)
    j2 = j_rp_update(j, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(t), None, 0.1)
    p2 = rp_update(p, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(t), None, 0.1)
    close(p2.projections, j2.projections)
    e = np.zeros(0, np.int32)
    with pytest.raises(ValueError):
        j_rp_update(j, jnp.asarray(e), jnp.asarray(e), jnp.asarray(e), None, 0.1)
    with pytest.raises(ValueError):
        rp_update(p, torch.from_numpy(e), torch.from_numpy(e), torch.from_numpy(e), None, 0.1)


def advanced_state(use_matrix=False, layers=2, dim=DIM):
    j = j_rp_init_state(N, layers, dim, float(T0), use_matrix, jax.random.PRNGKey(3))
    for src, dst, t, valid in update_chain(1):
        j = j_rp_update(j, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(t),
                        jnp.asarray(valid), 1e-3)
    return j


def copy_rp_weights(params, module):
    with torch.no_grad():
        for lin, name in ((module.fc1, "Dense_0"), (module.fc2, "Dense_1")):
            lin.weight.copy_(torch.tensor(np.asarray(params["params"][name]["kernel"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(params["params"][name]["bias"])))


PAIRS = (np.array([0, 3, -1, 10, 7, 2, 2], np.int32), np.array([1, -1, 2, 5, 11, 2, 9], np.int32))


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_rp_module_matches_jax(layers):
    kw = dict(num_nodes=N, num_layer=layers, time_decay_weight=1e-3, use_matrix=False,
              enforce_dim=DIM)
    j = JRP(**kw)
    js = advanced_state(layers=layers)
    src, dst = (jnp.asarray(a) for a in PAIRS)
    params = j.init(jax.random.PRNGKey(4), js, src, dst)
    p = RandomProjectionModule(**kw)
    assert p.out_dim == j.out_dim == (2 * layers + 2) ** 2 and p.dim == DIM
    copy_rp_weights(params, p)
    got = p(j_to_p(js), *(torch.from_numpy(a) for a in PAIRS))
    close(got.detach(), j.apply(params, js, src, dst))


def test_rp_module_without_concat_and_unscaled():
    kw = dict(num_nodes=N, num_layer=1, time_decay_weight=1e-3, use_matrix=True,
              concat_src_dst=False, scale_random_projection=False)
    js = advanced_state(use_matrix=True, layers=1, dim=N + 1)
    src, dst = (jnp.asarray(a) for a in PAIRS)
    params = JRP(**kw).init(jax.random.PRNGKey(5), js, src, dst)
    p = RandomProjectionModule(**kw)
    assert p.out_dim == 4 and p.dim == N + 1
    copy_rp_weights(params, p)
    close(p(j_to_p(js), *(torch.from_numpy(a) for a in PAIRS)).detach(),
          JRP(**kw).apply(params, js, src, dst))
    with pytest.raises(ValueError):
        RandomProjectionModule(N, 1, 0.1, use_matrix=False).dim


K, DN, DE, TIME, OUT = 6, 5, 4, 7, 12


def encoder_inputs(seed=0, B=4):
    rng = np.random.default_rng(seed)
    node_x = rng.normal(size=(N, DN)).astype(np.float32)
    src = rng.integers(0, N, B).astype(np.int32)
    dst = rng.integers(0, N, B).astype(np.int32)
    t = (T0 + 10_000 + rng.integers(0, 100, B)).astype(np.int32)
    nbrs = rng.integers(0, N, (2 * B, K)).astype(np.int32)
    nbrs[rng.random((2 * B, K)) < 0.3] = -1
    nbrs[1] = -1  # a seed without neighbours
    nt = (np.concatenate([t, t])[:, None] - rng.integers(0, 9000, (2 * B, K))).astype(np.int32)
    nx = rng.normal(size=(2 * B, K, DE)).astype(np.float32)
    return node_x, src, dst, t, nbrs, nt, nx


HEAD = {"params": {"mlp": {"Dense_0": {"kernel": np.zeros((2 * OUT, 64)), "bias": np.zeros(64)},
                           "Dense_1": {"kernel": np.zeros((64, 1)), "bias": np.zeros(1)}}}}


@pytest.mark.parametrize("with_rp", [True, False])
@pytest.mark.parametrize("mixers", [1, 2])
def test_tpnet_matches_jax(with_rp, mixers):
    rp_kw = dict(num_nodes=N, num_layer=2, time_decay_weight=1e-3, use_matrix=False,
                 enforce_dim=DIM)
    kw = dict(node_feat_dim=DN, edge_x_dim=DE, time_feat_dim=TIME, output_dim=OUT,
              num_neighbors=K, num_layers=mixers, dropout=0.0)
    jm = JTPNet(**kw, random_projections=JRP(**rp_kw) if with_rp else None)
    pm = TPNet(**kw, random_projections=RandomProjectionModule(**rp_kw) if with_rp else None)
    js = advanced_state() if with_rp else None
    inputs = encoder_inputs()
    jin = [jnp.asarray(a) for a in inputs]
    params = jm.init(jax.random.PRNGKey(6), *jin, js)
    # Random LayerNorm scales and biases, so the loader's mapping shows.
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), params)
    load_tpnet_params({"enc": params, "dec": HEAD}, pm, LinkPredictor(OUT))
    pz = torch.cat(pm(*(torch.from_numpy(a) for a in inputs),
                      None if js is None else j_to_p(js))).detach().numpy()
    jz = np.concatenate(jm.apply(params, *jin, js))
    # A seed whose neighbour slots are all padding (seed 1 here) feeds the
    # mixers nearly constant rows, where the two LayerNorms' roundings part
    # (the module docstring): 1e-4 there, 1e-5 elsewhere.
    all_pad = (inputs[4] == -1).all(1)
    assert all_pad.any() and not all_pad.all()
    close(pz[~all_pad], jz[~all_pad])
    close(pz[all_pad], jz[all_pad], tol=1e-4)
    with pytest.raises(ValueError):
        load_tpnet_params({"enc": params, "dec": HEAD},
                          TPNet(**kw, random_projections=None if with_rp else
                                RandomProjectionModule(**rp_kw)), LinkPredictor(OUT))


def test_tpnet_dropout_comes_from_the_generator():
    rp = RandomProjectionModule(N, 2, 1e-3, use_matrix=False, enforce_dim=DIM)
    m = TPNet(DN, DE, TIME, OUT, K, dropout=0.3, random_projections=rp)
    inputs = [torch.from_numpy(a) for a in encoder_inputs(1)]
    state = rp.init_state(torch.Generator().manual_seed(0))
    assert isinstance(state, RandomProjectionState)
    base = m(*inputs, state)[0]
    g = lambda: torch.Generator().manual_seed(5)
    assert torch.equal(m(*inputs, state, deterministic=True, generator=g())[0], base)
    a = m(*inputs, state, deterministic=False, generator=g())[0]
    b = m(*inputs, state, deterministic=False, generator=g())[0]
    assert torch.equal(a, b) and not torch.equal(a, base)
    with pytest.raises(ValueError):
        m(*inputs)  # random projections need a state
