"""Chunk-streamed epochs of the port (``tgm_tpu_torch.train.chunked``) against
the port's resident stream and the JAX package's ``train/chunked.py``.

A small stream (66 edges, 16 nodes, 3-dim edge features, batches of 10: 7
batches, the last one short) made with numpy from a seed. The chunked
stream must serve exactly the resident batch plan, and a chunked TGN epoch
(rowwise cores, the feature-layout recency hook, dims 8) must be bit-equal
to the resident epoch. Against JAX's ``chunked_hook_epoch`` two epochs run
with JAX's initial weights loaded and JAX's random negatives injected
(fault 5), dropout 0 and Adam at 1e-3 in both, the hook state and the
memory reset between the epochs as the TGN example resets them (a ring
carried into a second pass over the same times holds rows in no time
order, where the JAX jnp query and the port's K4 rule differ, ROADMAP
fault 1): per-batch losses within 5e-3, the first within 1e-5, and the
recency ring state exact after each epoch.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbeddingRowwise as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.train import ChunkedEdgeStream as JChunked
from tgm_tpu.train import chunked_hook_epoch as j_chunked_hook_epoch
from tgm_tpu.train.programs import build_tgn_hook_cores as j_build_cores
from tgm_tpu.util.seed import seed_everything as j_seed_everything
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.hooks import HookManager, RandomNegativeEdgeSamplerHook, RecencyNeighborHook
from tgm_tpu_torch.nn import GraphAttentionEmbeddingRowwise, LinkPredictor, TGNMemory
from tgm_tpu_torch.train import (
    ChunkedEdgeStream,
    DeviceEdgeStream,
    build_tgn_hook_cores,
    chunked_hook_epoch,
    scanned_hook_epoch,
)
from tgm_tpu_torch.weights import load_tgn_params

N, E, D, B, K, DIMS, LR = 16, 66, 3, 10, 4, 8, 1e-3
# JAX compiles one chunk program per chunk length: one chunk of the whole
# epoch keeps it to one compile. The port runs three-batch chunks against it.
JAX_CHUNK_BATCHES = 7
FIELDS = ("edge_src", "edge_dst", "edge_time", "edge_valid", "edge_ids", "edge_x")


def make_arrays(seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 500, E))
    edges = rng.integers(0, N, (E, 2))
    edge_x = rng.normal(size=(E, D)).astype(np.float32)
    return t, edges, edge_x


def port_graph(seed=0):
    return DGraph(DGData.from_raw(*make_arrays(seed), time_delta="s"))


def fields(batch):
    return {f: getattr(batch, f).numpy() for f in FIELDS if batch.has(f)}


@pytest.mark.parametrize("chunk_batches", [1, 3, 7, 100])
def test_chunked_stream_serves_the_resident_batch_plan(chunk_batches):
    dg = port_graph()
    jdg = JDGraph(JDGData.from_raw(*make_arrays(), time_delta="s"))
    res = DeviceEdgeStream(dg, B, device="cpu")
    ch = ChunkedEdgeStream(dg, B, chunk_batches, device="cpu")
    jch = JChunked(jdg, B, chunk_batches)
    assert (ch.num_batches, ch.num_chunks) == (res.num_batches, jch.num_chunks)
    got = 0
    for k in range(ch.num_chunks):
        chunk, jchunk = ch.put_chunk(k), jch.put_chunk(k)
        assert ch._chunk_len(k) == jch._chunk_len(k)
        for i in range(ch._chunk_len(k)):
            a, r = fields(ch.batch_at(chunk, i)), fields(res.batch_at(got))
            jb = jch.batch_at(jchunk, jnp.int32(i))
            assert a.keys() == r.keys() == set(FIELDS)
            for f in FIELDS:
                np.testing.assert_array_equal(a[f], r[f], err_msg=f"batch {got} {f}")
                np.testing.assert_array_equal(a[f], np.asarray(getattr(jb, f)),
                                              err_msg=f"batch {got} {f} against JAX")
            got += 1
    assert got == res.num_batches


@pytest.mark.parametrize("feat_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_chunk_nbytes_matches_jax(feat_dtype):
    jdg = JDGraph(JDGData.from_raw(*make_arrays(), time_delta="s"))
    jdt = None if feat_dtype is None else jnp.bfloat16
    ch = ChunkedEdgeStream(port_graph(), B, 3, feat_dtype=feat_dtype, device="cpu")
    assert ch.chunk_nbytes == JChunked(jdg, B, 3, feat_dtype=jdt).chunk_nbytes
    per_edge = 12 + D * (4 if feat_dtype is None else 2)
    assert ch.chunk_nbytes == 3 * B * per_edge + 3 * 4 + 4


def test_bf16_transit_is_bit_equal_to_the_ml_dtypes_round_trip():
    t, edges, edge_x = make_arrays()
    ch = ChunkedEdgeStream(port_graph(), B, 3, feat_dtype=torch.bfloat16, device="cpu")
    jch = JChunked(JDGraph(JDGData.from_raw(t, edges, edge_x, time_delta="s")), B, 3,
                   feat_dtype=jnp.bfloat16)
    want = edge_x.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = 0
    for k in range(ch.num_chunks):
        chunk, jchunk = ch.put_chunk(k), jch.put_chunk(k)
        for i in range(ch._chunk_len(k)):
            x = ch.batch_at(chunk, i).edge_x
            assert x.dtype == torch.float32
            n = min(B, E - got * B)
            np.testing.assert_array_equal(x[:n].numpy(), want[got * B: got * B + n])
            np.testing.assert_array_equal(
                x.numpy(), np.asarray(jch.batch_at(jchunk, jnp.int32(i)).edge_x))
            got += 1


def test_caller_arrays_are_kept_by_reference():
    t, edges, edge_x = make_arrays()
    src, dst = (np.ascontiguousarray(edges[:, j], np.int32) for j in (0, 1))
    t32 = t.astype(np.int32)
    ch = ChunkedEdgeStream.from_arrays(src, dst, t32, edge_x, B, 3, device="cpu")
    assert ch._src is src and ch._dst is dst and ch._t is t32
    assert ch._edge_x.data_ptr() == edge_x.ctypes.data  # the feature table is not copied
    assert ch._edge_x.shape == (E, D)  # nor padded: the last chunk is padded as it is put
    last = ch.put_chunk(ch.num_chunks - 1)
    b = ch.batch_at(last, ch._chunk_len(ch.num_chunks - 1) - 1)
    assert b.edge_valid.sum() == E % B and (b.edge_src[E % B:] == -1).all()
    assert (b.edge_ids[E % B:] == -1).all() and (b.edge_x[E % B:] == 0).all()


def test_bad_arguments_raise():
    dg = port_graph()
    with pytest.raises(ValueError, match="chunk_batches"):
        ChunkedEdgeStream(dg, B, 0, device="cpu")
    with pytest.raises(ValueError, match="feat_dtype"):
        ChunkedEdgeStream(dg, B, 3, feat_dtype=torch.float16, device="cpu")
    ch = ChunkedEdgeStream(dg, B, 3, device="cpu")
    with pytest.raises(IndexError):
        ch.put_chunk(ch.num_chunks)
    with pytest.raises(IndexError):
        ch.batch_at(ch.put_chunk(ch.num_chunks - 1), 1)  # the last chunk holds one batch
    no_x = ChunkedEdgeStream(dg, B, 3, include_features=False, device="cpu")
    assert not no_x.batch_at(no_x.put_chunk(0), 0).has("edge_x")
    assert no_x.chunk_nbytes == 3 * B * 12 + 3 * 4 + 4


# ---------------------------------------------------------------------- #
# Epochs
# ---------------------------------------------------------------------- #
def port_hm(negs=None):
    hm = HookManager(keys=["train"])
    rnd = RandomNegativeEdgeSamplerHook(low=0, high=N, device="cpu", seed=11)
    if negs is not None:
        it = iter(negs)
        rnd.draw_neg = lambda size: torch.from_numpy(next(it).copy())
    hm.register("train", rnd)
    # The feature layout (edge_x_full=None): the one recency layout that
    # scales past device memory; its buffers carry the features by value.
    rec = RecencyNeighborHook(N, [K], ["edge_src", "edge_dst", "neg"],
                              ["edge_time", "edge_time", "neg_time"], edge_dim=D, device="cpu")
    hm.register_shared(rec)
    return hm, rec


def port_model(params=None):
    torch.manual_seed(0)
    memory = TGNMemory(N, D, DIMS, DIMS)
    encoder = GraphAttentionEmbeddingRowwise(DIMS, DIMS, D, DIMS, dropout=0.0)
    decoder = LinkPredictor(node_dim=DIMS, hidden_dim=DIMS)
    if params is not None:
        load_tgn_params(params, memory, encoder, decoder)
    mods = (memory, encoder, decoder)
    opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=LR)
    core, _ = build_tgn_hook_cores(memory, encoder, decoder, opt, N, style="rowwise")
    return core, memory, mods


def run_port(stream_of, epochs=1, negs=None, params=None):
    """``epochs`` train epochs through ``stream_of(dg)``: the resident stream
    runs ``scanned_hook_epoch``, a chunked one ``chunked_hook_epoch``."""
    dg = port_graph()
    stream = stream_of(dg)
    hm, rec = port_hm(negs)
    core, memory, mods = port_model(params)
    run = chunked_hook_epoch if isinstance(stream, ChunkedEdgeStream) else scanned_hook_epoch
    epoch, states = run(stream, hm, "train", dg, core)
    mem_state, losses = memory.init_state("cpu"), []
    for _ in range(epochs):
        (mem_state, _), states, loss = epoch((mem_state, None), states)
        losses.append(loss)
    if hasattr(epoch, "close"):
        epoch.close()
    weights = [p.detach().clone() for m in mods for p in m.parameters()]
    return torch.cat(losses), mem_state, [s.clone() for s in rec.state], weights


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("chunk_batches", [3, 7])
def test_chunked_epoch_is_bit_equal_to_the_resident_epoch(chunk_batches):
    res = run_port(lambda dg: DeviceEdgeStream(dg, B, device="cpu"))
    ch = run_port(lambda dg: ChunkedEdgeStream(dg, B, chunk_batches, device="cpu"))
    assert ch[0].shape == (7,) and ch[0].device.type == "cpu"
    assert torch.equal(res[0], ch[0])
    for name in ("mem", "last_update", "s_other", "s_t", "s_valid", "d_other", "d_t",
                 "d_valid"):
        assert torch.equal(getattr(res[1], name), getattr(ch[1], name)), name
    assert_same(res[2], ch[2])
    assert_same(res[3], ch[3])


def test_two_chunked_epochs_carry_hook_state():
    """The second epoch starts from the first one's hook and memory state,
    as the resident epochs do, and the prefetched first chunk serves it."""
    res = run_port(lambda dg: DeviceEdgeStream(dg, B, device="cpu"), epochs=2)
    ch = run_port(lambda dg: ChunkedEdgeStream(dg, B, 3, device="cpu"), epochs=2)
    assert ch[0].shape == (14,) and torch.isfinite(ch[0]).all()
    assert not torch.equal(ch[0][7:], ch[0][:7])
    assert torch.equal(res[0], ch[0])
    assert torch.equal(res[1].mem, ch[1].mem)
    assert_same(res[2], ch[2])


def test_close_can_be_called_twice():
    dg = port_graph()
    hm, _ = port_hm()
    core, memory, _ = port_model()
    epoch, states = chunked_hook_epoch(ChunkedEdgeStream(dg, B, 3, device="cpu"), hm, "train",
                                       dg, core)
    epoch((memory.init_state("cpu"), None), states)
    epoch.close()
    epoch.close()


@pytest.fixture(scope="module")
def jax_run():
    """Two epochs of JAX's ``chunked_hook_epoch`` (the JAX chunked test's
    model at N = 16): initial weights, per-batch losses and negatives, and
    the recency state after each epoch."""
    j_seed_everything(11)
    t, edges, edge_x = make_arrays()
    dg = JDGraph(JDGData.from_raw(t, edges, edge_x, time_delta="s"))
    hm = JHookManager(keys=["train"])
    hm.register("train", JRandomNeg(low=0, high=N))
    hm.register_shared(JRecency(N, [K], ["edge_src", "edge_dst", "neg"],
                                ["edge_time", "edge_time", "neg_time"], edge_dim=D))
    memory = JMemory(num_nodes=N, raw_msg_dim=D, memory_dim=DIMS, time_dim=DIMS)
    encoder = JAttn(in_channels=DIMS, out_channels=DIMS, msg_dim=D, time_dim=DIMS,
                    dropout=0.0)
    decoder = JLinkPredictor(node_dim=DIMS, hidden_dim=DIMS)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    mem_state = memory.init_state()
    params = {
        "mem": memory.init(k1, mem_state, jnp.zeros(4, jnp.int32)),
        "enc": encoder.init(
            k2, jnp.zeros((4, DIMS)), jnp.zeros((4, 3, DIMS)), jnp.zeros(4, jnp.int32),
            jnp.zeros((4, 3), jnp.int32), jnp.zeros((4, 3, D)), jnp.ones((4, 3), bool),
        ),
        "dec": decoder.init(k3, jnp.zeros((1, DIMS)), jnp.zeros((1, DIMS))),
    }
    opt = optax.adam(LR)
    core, _ = j_build_cores(memory, encoder, decoder, opt, N, style="rowwise")

    def step(carry, batch):
        carry, loss = core(carry, batch)
        return carry, (loss, batch.neg)

    epoch, states = j_chunked_hook_epoch(JChunked(dg, B, JAX_CHUNK_BATCHES), hm, "train", dg,
                                         step, donate=False)
    carry = (params, opt.init(params), mem_state, k4)
    losses, negs, recs = [], [], []
    for _ in range(2):
        # A fresh hook state and memory each epoch; the weights carry over.
        carry = carry[:2] + (memory.init_state(), carry[3])
        carry, out_states, (loss, neg) = epoch(carry, states)
        losses.append(loss)
        negs.extend(neg)
        recs.append([np.asarray(x) for x in jax.tree_util.tree_leaves(out_states[-1])])
    epoch.close()
    return params, np.concatenate(losses), negs, recs


def test_two_chunked_epochs_match_jax(jax_run):
    params, j_losses, negs, j_recs = jax_run
    dg = port_graph()
    hm, rec = port_hm(negs)
    core, memory, _ = port_model(params)
    epoch, states = chunked_hook_epoch(ChunkedEdgeStream(dg, B, 3, device="cpu"), hm, "train",
                                       dg, core)
    losses = []
    for e in range(2):
        if e:
            hm.reset_state()
            _, states = hm.as_transform("train", dg)
        _, states, loss = epoch((memory.init_state("cpu"), None), states)
        losses.append(loss)
        # The hooks' order puts the shared recency hook first or last; find it.
        (ring,) = [s for s in states if isinstance(s, tuple)]
        assert len(ring) == len(j_recs[e])
        for got, want in zip(ring, j_recs[e]):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"epoch {e}")
    epoch.close()
    losses = torch.cat(losses).numpy()
    gap = np.abs(losses - j_losses)
    print(f"chunked TGN, two epochs against JAX: max loss gap {gap.max():.3g}")
    assert gap[0] <= 1e-5 and gap.max() <= 5e-3
