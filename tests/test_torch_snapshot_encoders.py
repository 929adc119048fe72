"""The snapshot encoders against the JAX package on the CPU.

GCN, TGCN, GC-LSTM (K = 1 and 2) and ROLAND (every update mechanism) run
over three snapshot steps of numpy-seeded graphs (padded -1 ids, masked
edges, a node without edges), the recurrent state carried from step to
step, from flax's init perturbed by seeded noise (so every bias and
ROLAND's ``tau`` are non-zero), loaded through the port's
``load_*_params``. Each step's outputs within 1e-5 of the largest
|value| (at least 1): both packages sum segments in another order. The
flax ``GRUCell`` mapping into ``torch.nn.GRUCell``'s stacked (r, z, n)
layout is checked alone too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tgm_tpu.nn import GCLSTM as JGCLSTM
from tgm_tpu.nn import GCN as JGCN
from tgm_tpu.nn import ROLAND as JROLAND
from tgm_tpu.nn import TGCN as JTGCN
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu_torch.nn import GCLSTM, GCN, ROLAND, TGCN, LinkPredictor, TorchGRUCell
from tgm_tpu_torch.weights import (
    load_flax_gru_cell,
    load_gclstm_params,
    load_gcn_params,
    load_roland_params,
    load_tgcn_params,
)

N, IN, D = 16, 5, 8
TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def snapshots(seed):
    """Node features and three padded snapshots of 20, 32 and 12 edges
    (width 40) over nodes 0..N-2; some real rows masked."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, IN)).astype(np.float32)
    out = []
    for n in (20, 32, 12):
        src = np.full(40, -1, np.int32)
        dst = np.full(40, -1, np.int32)
        src[:n] = rng.integers(0, N - 1, n)
        dst[:n] = rng.integers(0, N - 1, n)
        valid = np.arange(40) < n
        valid[rng.choice(n, 2, replace=False)] = False
        out.append((src, dst, valid))
    return x, out


def perturbed(params, seed):
    rng = np.random.default_rng(seed + 1000)
    return jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.2, params)


def dec_params(seed):
    dec = JLinkPredictor(node_dim=D, hidden_dim=D)
    return dec.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, D)), jnp.zeros((1, D)))


def port_dec():
    return LinkPredictor(node_dim=D, hidden_dim=D)


@pytest.mark.parametrize("seed", [0, 1])
def test_gcn_matches_jax(seed):
    x, snaps = snapshots(seed)
    jm = JGCN(hidden_dim=D, out_dim=D, num_layers=2)
    e4 = jnp.zeros(4, jnp.int32)
    params = {"enc": perturbed(jm.init(jax.random.PRNGKey(seed), x, e4, e4), seed),
              "dec": dec_params(seed)}
    pm = GCN(IN, D, D, num_layers=2)
    load_gcn_params(params, pm, port_dec())
    for src, dst, valid in snaps:
        want = jm.apply(params["enc"], x, src, dst, None, valid)
        got = pm(t(x), t(src), t(dst), None, t(valid))
        close(got.detach(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_tgcn_matches_jax_over_three_steps(seed):
    x, snaps = snapshots(seed)
    jm = JTGCN(in_channels=IN, out_channels=D)
    e4 = jnp.zeros(4, jnp.int32)
    params = {"enc": perturbed(jm.init(jax.random.PRNGKey(seed), x, e4, e4), seed),
              "dec": dec_params(seed)}
    pm = TGCN(IN, D)
    load_tgcn_params(params, pm, port_dec())
    H_j, H_p = None, None
    with torch.no_grad():
        for src, dst, valid in snaps:
            H_j = jm.apply(params["enc"], x, src, dst, None, H_j, valid)
            H_p = pm(t(x), t(src), t(dst), None, H_p, t(valid))
            close(H_p, H_j)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_gclstm_matches_jax_over_three_steps(K, seed):
    x, snaps = snapshots(seed)
    jm = JGCLSTM(in_channels=IN, out_channels=D, K=K)
    e4 = jnp.zeros(4, jnp.int32)
    params = {"enc": perturbed(jm.init(jax.random.PRNGKey(seed), x, e4, e4), seed),
              "dec": dec_params(seed)}
    pm = GCLSTM(IN, D, K)
    load_gclstm_params(params, pm, port_dec())
    H_j = C_j = H_p = C_p = None
    with torch.no_grad():
        for src, dst, valid in snaps:
            H_j, C_j = jm.apply(params["enc"], x, src, dst, None, H_j, C_j, valid)
            H_p, C_p = pm(t(x), t(src), t(dst), None, H_p, C_p, t(valid))
            close(H_p, H_j)
            close(C_p, C_j)


@pytest.mark.parametrize("update,tau0", [("moving", 0.5), ("learnable", 0.5), ("gru", 0.5),
                                         ("mlp", 0.5), (None, 0.3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_roland_matches_jax_over_three_steps(update, tau0, seed):
    x, snaps = snapshots(seed)
    jm = JROLAND(input_channel=IN, out_channel=D, num_nodes=N, update=update, tau0=tau0)
    e4 = jnp.zeros(4, jnp.int32)
    params = {"enc": perturbed(jm.init(jax.random.PRNGKey(seed), x, e4, e4), seed),
              "dec": dec_params(seed)}
    pm = ROLAND(IN, D, N, update=update, tau0=tau0)
    load_roland_params(params, pm, port_dec())
    if update == "learnable":
        assert float(pm.tau.detach()) != 0.0
    prev_j, prev_p = None, None
    n_prev_j, n_prev_p = jnp.asarray(1.0), torch.tensor(1.0)
    with torch.no_grad():
        for src, dst, valid in snaps:
            n_j = jnp.sum(jnp.asarray(valid).astype(jnp.float32))
            n_p = t(valid).float().sum()
            z_j, prev_j = jm.apply(params["enc"], x, src, dst, previous_embeddings=prev_j,
                                   num_current_edges=n_j, num_previous_edges=n_prev_j,
                                   edge_valid=valid)
            z_p, prev_p = pm(t(x), t(src), t(dst), previous_embeddings=prev_p,
                             num_current_edges=n_p, num_previous_edges=n_prev_p,
                             edge_valid=t(valid))
            n_prev_j, n_prev_p = n_j, n_p
            close(z_p, z_j)
            for a, b in zip(prev_p, prev_j):
                close(a, b)
            assert not any(h.requires_grad for h in prev_p)


def test_roland_rejects_an_unknown_update_and_a_foreign_tree():
    with pytest.raises(ValueError):
        ROLAND(IN, D, N, update="sum")
    jm = JROLAND(input_channel=IN, out_channel=D, num_nodes=N, update="gru")
    x, _ = snapshots(0)
    e4 = jnp.zeros(4, jnp.int32)
    params = {"enc": jm.init(jax.random.PRNGKey(0), x, e4, e4), "dec": dec_params(0)}
    with pytest.raises(ValueError):
        load_roland_params(params, ROLAND(IN, D, N, update="mlp"), port_dec())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flax_gru_cell_maps_into_torch_gru_layout(seed):
    """flax ``GRUCell(carry=h, inputs=x)`` equals the port's ``TorchGRUCell(h,
    x)`` and ``torch.nn.GRUCell(x, h)`` after ``load_flax_gru_cell``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(10, D)).astype(np.float32)
    h = rng.normal(size=(10, D)).astype(np.float32)
    cell = fnn.GRUCell(features=D)
    params = perturbed(cell.init(jax.random.PRNGKey(seed), h, x), seed)
    want, _ = cell.apply(params, h, x)
    for port in (TorchGRUCell(D, D), torch.nn.GRUCell(D, D)):
        load_flax_gru_cell(params["params"], port)
        assert torch.equal(port.bias_hh[: 2 * D], torch.zeros(2 * D))
        with torch.no_grad():
            got = port(t(h), t(x))[0] if isinstance(port, TorchGRUCell) else port(t(x), t(h))
        close(got, want)
