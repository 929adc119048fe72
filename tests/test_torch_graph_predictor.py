"""The port's ``GraphPredictor``, ``binary_accuracy`` and ``mse`` against the JAX package.

``GraphPredictor`` with the default mean pooling and with sum pooling,
with and without a ``valid`` mask (padded rows), on flax's initial weights
copied into the port's head: outputs within 1e-6 of the largest |output|
(at least 1), and the gradients of one squared-error loss against
``jax.grad`` within 1e-6 of each leaf's largest |g| (at least 1e-3 of the
largest leaf), ``z_nodes``' gradient included. ``binary_accuracy`` and
``mse`` (a 1-D mask broadcast over a 2-D error too) within 1e-6 of the
value (at least 1): the two packages sum in other orders. A
pooling without ``__call__`` and ``out_channels`` raises
``BadAggregatorProtocolError`` in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.eval import metrics as jmetrics
from tgm_tpu.exceptions import BadAggregatorProtocolError as JBadAggregator
from tgm_tpu.nn import GraphPredictor as JGraphPredictor
from tgm_tpu.nn.modules.aggregation import SumEmbdPooling as JSumPooling
from tgm_tpu_torch.eval import metrics as pmetrics
from tgm_tpu_torch.exceptions import BadAggregatorProtocolError
from tgm_tpu_torch.nn import GraphPredictor, SumEmbdPooling
from tgm_tpu_torch.weights import _head

N, D, OUT = 23, 12, 3


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def heads(pooling: str, hidden: int = 16, nlayers: int = 2):
    jpool = JSumPooling(D) if pooling == "sum" else None
    ppool = SumEmbdPooling(D) if pooling == "sum" else None
    jh = JGraphPredictor(in_dim=D, out_dim=OUT, nlayers=nlayers, hidden_dim=hidden,
                         graph_pooling=jpool)
    ph = GraphPredictor(D, OUT, nlayers=nlayers, hidden_dim=hidden, graph_pooling=ppool)
    variables = jh.init(jax.random.PRNGKey(3), jnp.zeros((4, D)))
    with torch.no_grad():
        _head(ph, variables)
    return jh, ph, variables


def inputs(seed: int, masked: bool):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(N, D)).astype(np.float32)
    valid = None
    if masked:
        valid = rng.random(N) < 0.6
        valid[-4:] = False  # padded rows
        z[-4:] = 0.0
    return z, valid, rng.normal(size=OUT).astype(np.float32)


CASES = [("mean", False), ("mean", True), ("sum", False), ("sum", True)]


@pytest.mark.parametrize("pooling,masked", CASES)
@pytest.mark.parametrize("nlayers", [2, 3])
def test_graph_predictor_matches_flax(pooling, masked, nlayers):
    jh, ph, variables = heads(pooling, nlayers=nlayers)
    z, valid, _ = inputs(nlayers, masked)
    jv = None if valid is None else jnp.asarray(valid)
    pv = None if valid is None else torch.from_numpy(valid)
    want = jh.apply(variables, jnp.asarray(z), jv)
    got = ph(torch.from_numpy(z), pv).detach()
    assert got.shape == (OUT,)
    close(got, want, 1e-6)


@pytest.mark.parametrize("pooling,masked", CASES)
def test_graph_predictor_gradients_match_jax_grad(pooling, masked):
    jh, ph, variables = heads(pooling)
    z, valid, target = inputs(7, masked)
    jv = None if valid is None else jnp.asarray(valid)

    def loss(v, zz):
        return jnp.sum((jh.apply(v, zz, jv) - target) ** 2)

    jg, jgz = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = ph(zt, None if valid is None else torch.from_numpy(valid))
    ((out - torch.from_numpy(target)) ** 2).sum().backward()
    # The JAX gradient tree mapped onto a second head, leaf by leaf.
    _, want_head, _ = heads(pooling)
    with torch.no_grad():
        _head(want_head, jg)
    grads = [p.grad for p in ph.parameters()]
    wants = [p.detach() for p in want_head.parameters()]
    floor = 1e-3 * max(float(w.abs().max()) for w in wants)
    for g, w in zip(grads + [zt.grad], wants + [torch.from_numpy(np.array(jgz))]):
        assert float((g - w).abs().max()) <= 1e-6 * max(float(w.abs().max()), floor)
    assert all(float(g.abs().max()) > 0 for g in grads)


def test_graph_predictor_rejects_a_bad_pooling():
    class NoChannels:
        def __call__(self, z, valid=None):
            return z.sum(0)

    with pytest.raises(BadAggregatorProtocolError):
        GraphPredictor(D, graph_pooling=NoChannels())
    with pytest.raises(JBadAggregator):
        JGraphPredictor(in_dim=D, graph_pooling=NoChannels()).init(
            jax.random.PRNGKey(0), jnp.zeros((2, D)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("threshold", [0.0, 0.25])
def test_binary_accuracy_matches_jax(masked, threshold):
    rng = np.random.default_rng(int(masked) + 2)
    pos = rng.normal(size=40).astype(np.float32)
    neg = rng.normal(size=40).astype(np.float32)
    pos[:3] = threshold  # on the threshold: a positive is wrong, a negative right
    neg[:3] = threshold
    valid = rng.random(40) < 0.7 if masked else None
    want = jmetrics.binary_accuracy(jnp.asarray(pos), jnp.asarray(neg), threshold,
                                    None if valid is None else jnp.asarray(valid))
    got = pmetrics.binary_accuracy(torch.from_numpy(pos), torch.from_numpy(neg), threshold,
                                   None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32
    close(got, want, 1e-6)
    if masked:  # no valid row: 0, not nan
        none = np.zeros(40, bool)
        assert float(pmetrics.binary_accuracy(torch.from_numpy(pos), torch.from_numpy(neg),
                                              threshold, torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("shape,mask", [((30,), None), ((30,), "1d"), ((30, 4), None),
                                        ((30, 4), "1d"), ((30, 4), "2d"), ((30,), "none")])
def test_mse_matches_jax(shape, mask):
    rng = np.random.default_rng(len(shape) * 10 + len(str(mask)))
    pred = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    valid = {None: None, "1d": rng.random(shape[0]) < 0.5, "2d": rng.random(shape) < 0.5,
             "none": np.zeros(shape[0], bool)}[mask]
    want = jmetrics.mse(jnp.asarray(pred), jnp.asarray(target),
                        None if valid is None else jnp.asarray(valid))
    got = pmetrics.mse(torch.from_numpy(pred), torch.from_numpy(target),
                       None if valid is None else torch.from_numpy(valid))
    close(got, want, 1e-6)
    if mask == "none":
        assert float(got) == 0.0
