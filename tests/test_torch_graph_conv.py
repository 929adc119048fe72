"""The port's graph convolutions against the JAX package on the CPU.

The same numpy-seeded graphs and weights (flax's init, copied into the
port's ``Linear`` layers) go through ``tgm_tpu.nn.modules.graph_conv`` and
``tgm_tpu_torch.nn.modules.graph_conv``: ``gcn_propagate``,
``laplacian_propagate``, ``GCNConv`` (plain, ``improved``, no self loops)
and ``ChebConv`` at K = 1, 2, 3, on edge lists with padded -1 ids, masked
edges, edge weights and isolated nodes. Forward values within 1e-5 of the
largest |value| (at least 1); the gradients of the parameters and of
``x`` against ``jax.grad`` within 1e-5 of each leaf's largest |g| (at
least 1e-3 of the largest leaf). Both packages sum the segments in
another order, hence the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.nn.modules import graph_conv as jgc
from tgm_tpu_torch.nn import ChebConv, GCNConv
from tgm_tpu_torch.nn.modules import graph_conv as pgc
from tgm_tpu_torch.weights import _cheb_conv, _gcn_conv

N, E, IN, OUT = 14, 48, 5, 6
TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} * {scale:.3g}"


def graph(seed, weighted=True, masked=True):
    """Edges over nodes 0..N-4 (N-3..N-1 isolated), the last 6 rows padded
    with -1 ids and invalid, a few real rows masked, weights in (0.5, 2)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N - 3, E).astype(np.int32)
    dst = rng.integers(0, N - 3, E).astype(np.int32)
    src[-6:], dst[-6:] = -1, -1
    valid = np.ones(E, bool)
    valid[-6:] = False
    if masked:
        valid[rng.choice(E - 6, 5, replace=False)] = False
    w = rng.uniform(0.5, 2.0, E).astype(np.float32) if weighted else None
    x = rng.normal(size=(N, IN)).astype(np.float32)
    return x, src, dst, w, valid, rng


CASES = [(0, True, True), (1, False, True), (2, True, False), (3, False, False)]


@pytest.mark.parametrize("seed,weighted,masked", CASES)
@pytest.mark.parametrize("c", [0.0, 1.0, 2.0])
def test_gcn_propagate_matches_jax(seed, weighted, masked, c):
    x, src, dst, w, valid, _ = graph(seed, weighted, masked)
    v = valid if masked else None
    want = jgc.gcn_propagate(x, src, dst, w, v, c)
    got = pgc.gcn_propagate(t(x), t(src), t(dst), None if w is None else t(w),
                            None if v is None else t(v), c)
    close(got, want)
    # Isolated nodes keep c / c * x (or 0 without self loops).
    close(got[N - 3 :], x[N - 3 :] if c > 0 else np.zeros_like(x[N - 3 :]))


@pytest.mark.parametrize("seed,weighted,masked", CASES)
def test_laplacian_propagate_matches_jax(seed, weighted, masked):
    x, src, dst, w, valid, _ = graph(seed, weighted, masked)
    v = valid if masked else None
    want = jgc.laplacian_propagate(x, src, dst, w, v)
    got = pgc.laplacian_propagate(t(x), t(src), t(dst), None if w is None else t(w),
                                  None if v is None else t(v))
    close(got, want)


def test_padded_ids_clamp_to_row_zero_as_a_jax_gather_does():
    """Unmasked -1 ids read and write row 0, never the last row."""
    x, src, dst, w, _, _ = graph(4, weighted=False, masked=False)
    want = jgc.gcn_propagate(x, src, dst, None, None, 1.0)
    got = pgc.gcn_propagate(t(x), t(src), t(dst), None, None, 1.0)
    close(got, want)
    # The last row is isolated: only its self loop.
    close(got[-1], x[-1])


def _conv_pair(flax_mod, port_mod, load, x, src, dst, w, valid, seed):
    params = flax_mod.init(jax.random.PRNGKey(seed), x, src, dst, w, valid)
    # Non-zero biases, so the copy of every leaf is checked.
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, params)
    with torch.no_grad():
        load(port_mod, params["params"])
    return params


def _grads(flax_mod, params, port_mod, x, src, dst, w, valid):
    rng = np.random.default_rng(7)
    r = rng.normal(size=(N, OUT)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(flax_mod.apply(p, xx, src, dst, w, valid) * r)

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    port_mod.zero_grad()
    (port_mod(xt, t(src), t(dst), None if w is None else t(w),
              None if valid is None else t(valid)) * t(r)).sum().backward()
    return g_p["params"], np.asarray(g_x), xt.grad.numpy()


def _close_grad(got, want):
    floor = 1e-3 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, wv in want.items():
        wv = np.asarray(wv)
        err = float(np.abs(got[name] - wv).max())
        assert err <= TOL * max(float(np.abs(wv).max()), floor), (name, err)


@pytest.mark.parametrize("improved,self_loops", [(False, True), (True, True), (False, False)])
@pytest.mark.parametrize("seed,weighted,masked", CASES[:2])
def test_gcn_conv_matches_jax(improved, self_loops, seed, weighted, masked):
    x, src, dst, w, valid, _ = graph(seed, weighted, masked)
    v = valid if masked else None
    jm = jgc.GCNConv(OUT, improved=improved, add_self_loops=self_loops)
    pm = GCNConv(IN, OUT, improved=improved, add_self_loops=self_loops)
    params = _conv_pair(jm, pm, _gcn_conv, x, src, dst, w, v, seed)
    want = jm.apply(params, x, src, dst, w, v)
    got = pm(t(x), t(src), t(dst), None if w is None else t(w), None if v is None else t(v))
    close(got.detach(), want)

    g_p, g_x, p_x = _grads(jm, params, pm, x, src, dst, w, v)
    close(p_x, g_x)
    _close_grad({"kernel": pm.lin.weight.grad.numpy().T, "bias": pm.bias.grad.numpy()},
                {"kernel": g_p["Dense_0"]["kernel"], "bias": g_p["bias"]})


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("seed,weighted,masked", CASES)
def test_cheb_conv_matches_jax(K, seed, weighted, masked):
    x, src, dst, w, valid, _ = graph(seed, weighted, masked)
    v = valid if masked else None
    jm = jgc.ChebConv(OUT, K)
    pm = ChebConv(IN, OUT, K)
    params = _conv_pair(jm, pm, _cheb_conv, x, src, dst, w, v, seed)
    want = jm.apply(params, x, src, dst, w, v)
    got = pm(t(x), t(src), t(dst), None if w is None else t(w), None if v is None else t(v))
    close(got.detach(), want)

    g_p, g_x, p_x = _grads(jm, params, pm, x, src, dst, w, v)
    close(p_x, g_x)
    got_g = {f"lin_{k}": pm.lins[k].weight.grad.numpy().T for k in range(K)}
    got_g["bias"] = pm.bias.grad.numpy()
    want_g = {f"lin_{k}": g_p[f"lin_{k}"]["kernel"] for k in range(K)}
    want_g["bias"] = g_p["bias"]
    _close_grad(got_g, want_g)


def test_cheb_conv_at_k1_reads_no_edge():
    """``ChebConv(K=1)`` is lin_0(x) + bias: the edges do not matter (the
    GC-LSTM examples' default K)."""
    x, src, dst, w, valid, _ = graph(0)
    pm = ChebConv(IN, OUT, 1)
    a = pm(t(x), t(src), t(dst), t(w), t(valid))
    b = pm(t(x), t(src[:0]), t(dst[:0]), None, None)
    assert torch.equal(a, b)
