"""CTAN's modules against the JAX package on the CPU.

The same numpy-seeded inputs and the same weights (JAX's init, loaded by
``tgm_tpu_torch.weights.load_ctan_params``) go through flax and the port:
``_EdgeTransformerConv`` and ``CTAN`` within 1e-5 (one and two
antisymmetric steps, invalid edges, PAD ends, a node whose every incoming
edge is invalid), the gradients within 1e-5 * max |g| per leaf (at least 1e-3 of the
largest leaf: the key bias's gradient is zero up to rounding), and
``ctan_memory_update`` bit-exact on time ties, duplicate endpoints,
invalid rows and writes aimed at the dump row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.ctan import CTAN as JCTAN
from tgm_tpu.nn.encoder.ctan import _EdgeTransformerConv as JConv
from tgm_tpu.nn.encoder.ctan import ctan_memory_init as j_init
from tgm_tpu.nn.encoder.ctan import ctan_memory_update as j_update
from tgm_tpu_torch.nn import CTAN, LinkPredictor, ctan_memory_init, ctan_memory_update
from tgm_tpu_torch.nn.encoder.ctan import _EdgeTransformerConv
from tgm_tpu_torch.weights import _dense, load_ctan_params

U, E, D, NODE_D, EDGE_D, TIME_D = 12, 40, 16, 3, 5, 6


def t(a):
    return torch.from_numpy(np.array(a))


def graph(seed):
    """Local edges with PAD ends, invalid edges, and node U - 1 reached only
    by invalid edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, U, E).astype(np.int32)
    dst = rng.integers(-1, U - 1, E).astype(np.int32)
    valid = rng.random(E) < 0.8
    dst[:3] = U - 1
    valid[:3] = False
    return rng, src, dst, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_transformer_conv_matches_jax(seed):
    rng, src, dst, valid = graph(seed)
    x = rng.normal(size=(U, D)).astype(np.float32)
    attr = rng.normal(size=(E, EDGE_D)).astype(np.float32)
    conv = JConv(out_channels=D)
    params = conv.init(jax.random.PRNGKey(seed), x, src, dst, attr, valid)
    want = np.asarray(conv.apply(params, x, src, dst, attr, valid))

    port = _EdgeTransformerConv(D, EDGE_D, D)
    with torch.no_grad():
        for i, name in enumerate(("lin_edge", "lin_query", "lin_key", "lin_value")):
            _dense(getattr(port, name), params["params"][f"Dense_{i}"])
    got = port(t(x), t(src), t(dst), t(attr), t(valid)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(got[U - 1] == 0.0)  # no valid edge into it


def ctan_pair(seed, num_iters):
    rng, src, dst, valid = graph(seed)
    node_x = rng.normal(size=(U, D + NODE_D)).astype(np.float32)
    last = rng.integers(0, 2_000_000, U).astype(np.int32)
    times = rng.integers(0, 2_000_000, E).astype(np.int32)
    msg = rng.normal(size=(E, EDGE_D)).astype(np.float32)
    kw = dict(edge_dim=EDGE_D, memory_dim=D, time_dim=TIME_D, node_dim=NODE_D,
              num_iters=num_iters, mean_delta_t=5.0e5, std_delta_t=3.0e5)
    jm, dec = JCTAN(**kw), JLinkPredictor(node_dim=D, hidden_dim=D)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"enc": jm.init(k1, node_x, last, src, dst, times, msg, valid),
              "dec": dec.init(k2, jnp.zeros((1, D)), jnp.zeros((1, D)))}
    port, pdec = CTAN(**kw), LinkPredictor(node_dim=D, hidden_dim=D)
    load_ctan_params(params, port, pdec)
    inputs = (node_x, last, src, dst, times, msg, valid)
    return jm, dec, params, port, pdec, inputs


@pytest.mark.parametrize("num_iters", [1, 2])
def test_ctan_matches_jax(num_iters):
    jm, _, params, port, _, inputs = ctan_pair(3, num_iters)
    want = np.asarray(jm.apply(params["enc"], *inputs))
    got = port(*map(t, inputs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Without a mask every edge counts, as in JAX.
    want = np.asarray(jm.apply(params["enc"], *inputs[:-1]))
    got = port(*map(t, inputs[:-1])).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ctan_gradients_match_jax():
    """d(sum of the decoder's scores over node pairs)/d(params), per leaf,
    within 1e-5 * the leaf's max |g|."""
    jm, dec, params, port, pdec, inputs = ctan_pair(4, 2)
    a = np.arange(U, dtype=np.int32)
    b = np.roll(a, 3)

    def loss(p):
        z = jm.apply(p["enc"], *inputs)
        return jnp.sum(jnp.tanh(dec.apply(p["dec"], z[a], z[b])))

    grads = jax.grad(loss)(params)
    z = port(*map(t, inputs))
    torch.tanh(pdec(z[t(a).long()], z[t(b).long()])).sum().backward()
    want_enc, want_dec = CTAN(edge_dim=EDGE_D, memory_dim=D, time_dim=TIME_D,
                              node_dim=NODE_D), LinkPredictor(node_dim=D, hidden_dim=D)
    load_ctan_params(grads, want_enc, want_dec)
    pairs = list(zip([*port.named_parameters(), *pdec.named_parameters()],
                     [*want_enc.parameters(), *want_dec.parameters()]))
    top = max(float(q.detach().abs().max()) for _, q in pairs)
    for (name, p), q in pairs:
        # The key bias moves every logit of a softmax segment alike, so its
        # gradient is zero up to rounding: leaves are held to at least 1e-3
        # of the largest leaf.
        scale = max(float(q.detach().abs().max()), 1e-3 * top)
        err = float((p.grad - q.detach()).abs().max()) / scale
        assert err <= 1e-5, (name, err)


def update_case(seed, n_nodes=10, e=8):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, e).astype(np.int32)
    dst = rng.integers(0, n_nodes, e).astype(np.int32)
    times = np.sort(rng.integers(0, 4, e)).astype(np.int32)  # many ties
    src[1] = dst[5] = 3  # node 3 twice, at one time
    times[1] = times[5] = 2
    src[2] = dst[2] = 7  # a self loop
    src[6] = n_nodes  # a write aimed at the dump row
    valid = np.ones(e, bool)
    valid[4] = False
    s_emb = rng.normal(size=(e, D)).astype(np.float32)
    d_emb = rng.normal(size=(e, D)).astype(np.float32)
    return src, dst, times, s_emb, d_emb, valid, rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memory_update_is_exact(seed):
    n_nodes = 10
    args = update_case(seed, n_nodes)
    rng = args[-1]
    js = j_init(n_nodes, D, init_time=1)
    ps = ctan_memory_init(n_nodes, D, init_time=1)
    assert tuple(ps.memory.shape) == js.memory.shape and ps.last_update.dtype == torch.int32
    np.testing.assert_array_equal(ps.last_update.numpy(), np.asarray(js.last_update))
    # A state that already holds values, dump row included.
    mem0 = rng.normal(size=js.memory.shape).astype(np.float32)
    last0 = rng.integers(0, 3, js.last_update.shape).astype(np.int32)
    js = js._replace(memory=jnp.asarray(mem0), last_update=jnp.asarray(last0))
    ps = ps._replace(memory=t(mem0), last_update=t(last0))
    for step in range(2):
        batch = args[:-1]
        js = j_update(js, *map(jnp.asarray, batch))
        out = ctan_memory_update(ps, *map(t, batch))
        assert out is ps
        np.testing.assert_array_equal(ps.memory.numpy(), np.asarray(js.memory))
        np.testing.assert_array_equal(ps.last_update.numpy(), np.asarray(js.last_update))
        assert np.all(ps.memory.numpy()[-1] == 0) and ps.last_update[-1] == 0
        args = update_case(seed + 10 + step, n_nodes)
    # Without a mask every row is valid.
    js = j_update(js, *map(jnp.asarray, args[:5]))
    ctan_memory_update(ps, *map(t, args[:5]))
    np.testing.assert_array_equal(ps.memory.numpy(), np.asarray(js.memory))
    np.testing.assert_array_equal(ps.last_update.numpy(), np.asarray(js.last_update))


def test_memory_update_writes_the_earliest_of_the_latest_rows():
    s = ctan_memory_init(4, 2)
    src, dst = torch.tensor([1, 2, 1], dtype=torch.int32), torch.tensor([2, 1, 3],
                                                                         dtype=torch.int32)
    times = torch.tensor([5, 7, 7], dtype=torch.int32)
    s_emb = torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
    d_emb = -s_emb
    ctan_memory_update(s, src, dst, times, s_emb, d_emb)
    # Node 1 at time 7: src row 2 (position 2) and dst row 1 (position 4);
    # the earlier position wins.
    assert s.memory[1].tolist() == [3.0, 3.0] and int(s.last_update[1]) == 7
    assert s.memory[2].tolist() == [2.0, 2.0] and s.memory[3].tolist() == [-3.0, -3.0]
