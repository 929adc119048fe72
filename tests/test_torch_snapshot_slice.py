"""Two epochs of each snapshot link example against the JAX examples on the CPU.

The JAX examples (``examples/linkproppred/{gcn,tgcn,gclstm,roland}.py``)
run their own ``main`` on a small numpy-seeded stream (their
``load_dataset`` replaced by it), through ``run_snapshot_linkpred``'s
schedule mode; each epoch's per-step outputs are recorded where
``scanned_snapshot_epoch`` returns them. The port's examples build from the
same stream and candidates, take the JAX initial weights
(``load_*_params``) and the JAX negatives (replayed from the hook's key,
fed through the port hook's ``draw_neg``), and run ``run``. Bands, as for
every training slice: the first loss within 1e-5, every per-batch loss
within 5e-3, val MRR within 0.01, test MRR within 0.02.

Both packages leave the encoder's parameters at their initial values
(ROADMAP fault 22: the snapshot step's output is detached, so the loss
reaches the decoder alone).
"""

import copy
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tgm_tpu.train.snapshot as j_snapshot  # noqa: E402
from tgm_tpu import DGData as JDGData  # noqa: E402
from tgm_tpu.util.seed import fork_key, seed_everything  # noqa: E402
from tgm_tpu_torch import DGData  # noqa: E402
from tgm_tpu_torch import weights  # noqa: E402
from tgm_tpu_torch.examples import _snapshot_common as common  # noqa: E402
from tgm_tpu_torch.examples.linkproppred import gclstm, gcn, roland, tgcn  # noqa: E402

N, E, Q, SEED = 60, 1_000, 5, 11
FLAGS = ["--epochs", "2", "--bsize", "50", "--embed-dim", "16", "--snapshot-ticks", "400",
         "--seed", str(SEED)]
PORT = {"gcn": (gcn, weights.load_gcn_params), "tgcn": (tgcn, weights.load_tgcn_params),
        "gclstm": (gclstm, weights.load_gclstm_params),
        "roland": (roland, weights.load_roland_params)}
CASES = [("gcn", []), ("tgcn", []), ("gclstm", []), ("gclstm", ["--K", "2"]),
         ("roland", []), ("roland", ["--update", "moving"]), ("roland", ["--update", "gru"])]


def make_stream():
    """Edges with a skewed node activity over 12,000 s, and Q candidates per
    val and test edge."""
    rng = np.random.default_rng(SEED)
    pop = rng.zipf(1.6, N).astype(np.float64)
    pop /= pop.sum()
    src = rng.choice(N, E, p=pop)
    dst = (src + 1 + rng.choice(N - 1, E)) % N
    t = np.sort(rng.integers(0, 12_000, E))
    kw = dict(edge_time=t, edge_index=np.stack([src, dst], 1).astype(np.int32), time_delta="s")
    data = DGData.from_raw(**kw)
    _, val, test = data.split()
    cands = (rng.integers(0, N, (val.num_edge_events, Q)),
             rng.integers(0, N, (test.num_edge_events, Q)))
    return kw, cands


def run_jax(name, argv, kw, cands, monkeypatch):
    """The JAX example's ``main`` on the stream; returns its initial params,
    final carry, the args and each built epoch's per-run outputs."""
    mod = importlib.import_module(f"examples.linkproppred.{name}")
    got, built = {}, []
    monkeypatch.setattr(mod, "load_dataset", lambda _: (JDGData.from_raw(**kw), *cands))
    real_run = mod.run_snapshot_linkpred

    def run(args, *a, **k):
        got["args"], got["params"] = args, a[6]
        got["carry"] = real_run(args, *a, **k)
        return got["carry"]

    real_epoch = j_snapshot.scanned_snapshot_epoch

    def recorded_epoch(kinds, idxs, *a, **k):
        epoch = real_epoch(kinds, idxs, *a, **k)
        entry = SimpleNamespace(kinds=np.asarray(kinds), runs=[])
        built.append(entry)

        def wrapped(carry):
            carry, x, y = epoch(carry)
            entry.runs.append((np.asarray(x), np.asarray(y)))
            return carry, x, y

        return wrapped

    monkeypatch.setattr(mod, "run_snapshot_linkpred", run)
    monkeypatch.setattr(j_snapshot, "scanned_snapshot_epoch", recorded_epoch)
    monkeypatch.setattr(sys, "argv", [name, *FLAGS, *argv])
    mod.main()
    return got, built


def jax_negatives(args, train_dst, n_batches):
    """The JAX random-negative hook's draws, replayed from its key: the
    first ``fork_key()`` after ``seed_everything``, split once a batch."""
    seed_everything(args.seed)
    key = fork_key()
    low, high = int(train_dst.min()), int(train_dst.max())
    out = []
    for _ in range(args.epochs * n_batches):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (args.bsize,), low, high, dtype=jnp.int32)))
    return out


def feed(hook, negs):
    """Replace ``hook``'s draws by ``negs``, in order; returns the iterator."""
    it = iter(negs)
    hook.draw_neg = lambda size: torch.from_numpy(next(it).copy())
    return it


def snapshot(mod):
    return {k: v.detach().clone() for k, v in mod.state_dict().items()}


def largest_move(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("name,argv", CASES)
def test_two_epochs_match_the_jax_example(name, argv, monkeypatch, capsys):
    kw, cands = make_stream()
    got, built = run_jax(name, argv, kw, cands, monkeypatch)
    args = got["args"]
    train, val, test = built
    n_batches = int((train.kinds == 1).sum())
    train_dst = JDGData.from_raw(**kw).split()[0].edge_index[:, 1]
    negs = jax_negatives(args, train_dst, n_batches)

    mod, load = PORT[name]
    p_args = mod.parse_args([*FLAGS, *argv, "--device", "cpu"])
    ctx = mod.build(p_args, data=DGData.from_raw(**kw), cands=copy.deepcopy(cands))
    assert np.array_equal(ctx.setup.train_data.edge_index[:, 1], train_dst)
    load(got["params"], ctx.encoder, ctx.decoder)
    it = feed(ctx.neg_hook, negs)
    enc0, dec0 = snapshot(ctx.encoder), snapshot(ctx.decoder)
    out = common.run(ctx, p_args)
    assert next(it, None) is None

    j_losses = [x[train.kinds == 1] for x, _ in train.runs]
    j_val = [float(s.sum() / max(float(c.sum()), 1.0)) for s, c in val.runs]
    j_test = [float(s.sum() / max(float(c.sum()), 1.0)) for s, c in test.runs]
    loss_diff = [np.abs(np.asarray(p) - j).max() for p, j in zip(out["losses"], j_losses)]
    first = abs(out["losses"][0][0] - float(j_losses[0][0]))
    val_diff = max(abs(a - b) for a, b in zip(out["val_mrr"], j_val))
    test_diff = abs(out["test_mrr"] - j_test[-1])
    print(f"{name} {argv}: {n_batches} train batches an epoch, {int((train.kinds == 0).sum())} "
          f"snapshot steps; first-loss diff {first:.3g}, max loss diff {max(loss_diff):.3g}; "
          f"val MRR {out['val_mrr']} (JAX {j_val}), test {out['test_mrr']:.5f} "
          f"(JAX {j_test}); JAX mean losses {[float(x.mean()) for x in j_losses]}")
    assert len(out["losses"]) == 2 and all(len(p) == n_batches for p in out["losses"])
    assert len(test.runs) >= 1
    assert first <= 1e-5
    assert max(loss_diff) <= 5e-3
    assert val_diff <= 0.01 and test_diff <= 0.02

    # Fault 22: the encoder never moves, in either package; the decoder does.
    j_params = got["carry"][0]
    j_enc_move = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(j_params["enc"]),
        jax.tree_util.tree_leaves(got["params"]["enc"])))
    j_dec_move = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(j_params["dec"]),
        jax.tree_util.tree_leaves(got["params"]["dec"])))
    assert j_enc_move == 0.0 and j_dec_move > 0.0
    assert largest_move(snapshot(ctx.encoder), enc0) == 0.0
    assert largest_move(snapshot(ctx.decoder), dec0) > 0.0
    # The trained decoders agree as the losses do.
    j_dec = type(ctx.decoder)(node_dim=16, hidden_dim=16)
    with torch.no_grad():
        weights._head(j_dec, j_params["dec"])
    assert largest_move(snapshot(ctx.decoder), snapshot(j_dec)) <= 5e-3
