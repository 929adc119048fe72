"""GraphMixer's modules against the JAX package, and the encoder protocol.

* ``FeedForwardNet`` and ``MLPMixer`` against flax on the same weights,
  inputs made with numpy from a seed, within fp32 1e-5 (dropout 0); the
  dropout masks come from the generator passed and only then.
* The GraphMixer example's ``GraphMixerEncoder`` against JAX's on one
  batch of hook products (PAD neighbours, seeds at PAD, gaps past 2^24),
  within 1e-5 * max |z|; its Time2Vec gets no gradient.
* ``HookManager.validate_requirement``: the same accept or raise as JAX on
  a good encoder, a missing attribute (with the same suggestions) and a
  non-encoder.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgm_tpu.exceptions as jexc
from examples.linkproppred.graphmixer import GraphMixerEncoder as JGraphMixerEncoder
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TimeGapNeighborMeanHook as JTimeGap
from tgm_tpu.nn import FeedForwardNet as JFeedForwardNet
from tgm_tpu.nn import MLPMixer as JMLPMixer
from tgm_tpu_torch import exceptions as pexc
from tgm_tpu_torch.examples.linkproppred.graphmixer import GraphMixerEncoder
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TimeGapNeighborMeanHook
from tgm_tpu_torch.nn import EncoderModule, FeedForwardNet, MLPMixer
from tgm_tpu_torch.weights import load_graphmixer_params, load_mlp_mixer_params

TOL = 1e-5


def close(got, want, tol=TOL, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0) if rel else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_feed_forward_net_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4, 10)).astype(np.float32)
    jm = JFeedForwardNet(input_dim=10, dim_expansion_factor=0.5)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    pm = FeedForwardNet(10, 0.5)
    assert pm.fc1.out_features == 5
    with torch.no_grad():
        for lin, name in ((pm.fc1, "Dense_0"), (pm.fc2, "Dense_1")):
            lin.weight.copy_(torch.tensor(np.asarray(params[name]["kernel"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))
    close(pm(torch.from_numpy(x)).detach(), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("tokens,channels", [(5, 12), (20, 172)])
def test_mlp_mixer_matches_flax(tokens, channels):
    rng = np.random.default_rng(tokens)
    x = (rng.normal(size=(7, tokens, channels)) * 3 + 1).astype(np.float32)
    jm = JMLPMixer(num_tokens=tokens, num_channels=channels)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    # Random LayerNorm scales and biases, so the loader's mapping shows.
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), variables)
    pm = MLPMixer(tokens, channels)
    load_mlp_mixer_params(variables, pm)
    assert pm.token_ffn.fc1.out_features == int(0.5 * tokens)
    assert pm.channel_ffn.fc1.out_features == 4 * channels
    close(pm(torch.from_numpy(x)).detach(), jm.apply(variables, jnp.asarray(x)), rel=True)


def test_mlp_mixer_dropout_comes_from_the_generator():
    x = torch.randn(3, 5, 8)
    m = MLPMixer(5, 8, dropout=0.5)
    base = m(x)
    assert torch.equal(m(x, None), base)  # no generator: no dropout, in any mode
    a = m(x, torch.Generator().manual_seed(3))
    b = m(x, torch.Generator().manual_seed(3))
    c = m(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, base) and not torch.equal(a, c)


# ---------------------------------------------------------------------- #
# The encoder
# ---------------------------------------------------------------------- #
N, K, DE, DN, TIME, EMB = 30, 6, 8, 5, 7, 12


def hook_batch(seed=0, B=4, Q=3):
    """Hook products of one batch as numpy: seeds [src | dst | neg]."""
    rng = np.random.default_rng(seed)
    S = 2 * B + Q
    src = rng.integers(0, N, B).astype(np.int32)
    dst = rng.integers(0, N, B).astype(np.int32)
    neg = rng.integers(0, N, Q).astype(np.int32)
    neg[-1] = -1  # a PAD seed reads node row 0, as in JAX
    neg[0] = N + 3  # an id past the node table reads its last row, as a JAX gather clamps
    # Times past 2^24: the int32 gap is cast once, not the two times.
    t0 = 2 ** 25 + 3
    seed_times = (t0 + rng.integers(0, 1000, S)).astype(np.int32)
    nbr = rng.integers(0, N, (S, K)).astype(np.int32)
    nbr[rng.random((S, K)) < 0.3] = -1
    nbr[0] = -1  # a seed without neighbours
    nt = (seed_times[:, None] - rng.integers(1, 5000, (S, K))).astype(np.int32)
    nx = rng.normal(size=(S, K, DE)).astype(np.float32)
    nx[nbr == -1] = 0.0
    tg = rng.normal(size=(S, DN)).astype(np.float32)
    node_x = rng.normal(size=(N, DN)).astype(np.float32)
    fields = dict(edge_src=src, edge_dst=dst, neg=neg, seed_times=[seed_times], nbr_nids=[nbr],
                  nbr_edge_time=[nt], nbr_edge_x=[nx], time_gap_feat=tg)
    return fields, node_x


def as_batch(fields, conv):
    return SimpleNamespace(**{k: [conv(a) for a in v] if isinstance(v, list) else conv(v)
                              for k, v in fields.items()})


def test_graphmixer_encoder_matches_jax():
    fields, node_x = hook_batch()
    jb, pb = as_batch(fields, jnp.asarray), as_batch(fields, torch.from_numpy)
    jm = JGraphMixerEncoder(time_dim=TIME, embed_dim=EMB, num_tokens=K, node_dim=DN,
                            edge_dim=DE, dropout=0.0)
    params = jm.init(jax.random.PRNGKey(0), jb, jnp.asarray(node_x))
    pm = GraphMixerEncoder(TIME, EMB, K, DN, DE, dropout=0.0)
    from tgm_tpu_torch.nn import LinkPredictor

    load_graphmixer_params({"enc": params, "dec": {"params": {"mlp": {
        "Dense_0": {"kernel": np.zeros((2 * EMB, 64)), "bias": np.zeros(64)},
        "Dense_1": {"kernel": np.zeros((64, 1)), "bias": np.zeros(1)}}}}},
        pm, LinkPredictor(EMB))
    want = np.asarray(jm.apply(params, jb, jnp.asarray(node_x)))
    got = pm(pb, torch.from_numpy(node_x))
    close(got.detach(), want, rel=True)
    # The Time2Vec is frozen: no gradient reaches it; the rest train.
    got.sum().backward()
    assert pm.time_encoder.w.weight.grad is None and pm.time_encoder.w.bias.grad is None
    assert pm.link_proj.weight.grad.abs().sum() > 0


def test_graphmixer_encoder_dropout_comes_from_the_generator():
    fields, node_x = hook_batch(1)
    pb = as_batch(fields, torch.from_numpy)
    pm = GraphMixerEncoder(TIME, EMB, K, DN, DE, dropout=0.3)
    x = torch.from_numpy(node_x)
    base = pm(pb, x)
    a = pm(pb, x, torch.Generator().manual_seed(0))
    b = pm(pb, x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, base)


# ---------------------------------------------------------------------- #
# validate_requirement
# ---------------------------------------------------------------------- #
def managers():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, 50), rng.integers(0, N, 50)
    t = np.sort(rng.integers(0, 100, 50))
    node_x = rng.normal(size=(N, DN)).astype(np.float32)
    keys = ["edge_src", "edge_dst"]
    jhm, phm = JHookManager(keys=["a", "b"]), HookManager(keys=["a", "b"])
    for hm, rec, tg in ((jhm, JRecency, JTimeGap), (phm, RecencyNeighborHook,
                                                     TimeGapNeighborMeanHook)):
        kw = {} if hm is jhm else {"device": "cpu"}
        hm.register_shared(rec(N, [K], keys, ["edge_time", "edge_time"], **kw))
        hm.register("a", tg(src, dst, t, node_x, 10, keys, **kw))
    return jhm, phm


class Requires:
    def __init__(self, requires):
        self.requires = set(requires)

    def __call__(self, batch, *args, **kwargs):
        return batch


def outcome(hm, module, key=None):
    try:
        hm.validate_requirement(module, key)
    except Exception as e:  # noqa: BLE001 - the outcome is the exception's kind
        return type(e).__name__, str(e)
    return "ok", ""


@pytest.mark.parametrize("requires,key", [
    ({"nbr_nids", "time_gap_feat", "edge_src"}, "a"),  # good under "a"
    ({"nbr_nids", "time_gap_feat"}, None),  # "b" lacks the time-gap hook
    ({"nbr_nid"}, "a"),  # a close name
    ({"node_analytics"}, "b"),  # a keyword of another hook's docs
    ({"no_such_attribute_anywhere"}, "a"),
])
def test_validate_requirement_matches_jax(requires, key):
    jhm, phm = managers()
    j, p = outcome(jhm, Requires(requires), key), outcome(phm, Requires(requires), key)
    assert p == j
    assert (p[0] == "ok") == (key == "a" and "edge_src" in requires)


def test_validate_requirement_on_encoders_and_non_encoders():
    jhm, phm = managers()
    enc = GraphMixerEncoder(TIME, EMB, K, DN, DE)
    assert isinstance(enc, EncoderModule)
    # The GraphMixer encoder needs the negatives and the time-gap mean.
    kind, msg = outcome(phm, enc, "a")
    assert kind == "UnresolvableHookDependenciesError" and "'neg'" in msg
    assert outcome(phm, enc, "a") == outcome(
        jhm, JGraphMixerEncoder(TIME, EMB, K, DN, DE), "a")
    for bad in (object(), lambda batch: batch, torch.nn.Linear(2, 2)):
        assert outcome(phm, bad)[0] == outcome(jhm, bad)[0] == "BadEncoderProtocolError"
    with pytest.raises(pexc.BadEncoderProtocolError):
        phm.validate_requirement(object())
    with pytest.raises(jexc.BadEncoderProtocolError):
        jhm.validate_requirement(object())
    with pytest.raises(KeyError):
        phm.validate_requirement(Requires({"edge_src"}), "c")
