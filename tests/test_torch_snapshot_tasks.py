"""The snapshot node and graph examples against the JAX examples on the CPU.

The JAX examples (``examples/nodeproppred/{gcn,tgcn,gclstm,persistant_forecast}.py``
and ``examples/graphproppred/{gcn,tgcn,persistant_forecast}.py``) run
their own ``main`` on small numpy-seeded streams, their ``load_dataset``
replaced. Their initial parameters are read where ``optax.adam``'s
``init`` receives them, and each jitted call's inputs and outputs where
``jax.jit`` hands them back; a split starts where the example builds a
snapshot loader. The port's examples build from the same stream, take the
JAX initial weights (``weights.load_*_params``) and run. Bands:

* graph paths, two epochs: the first loss within 1e-5, every loss within
  5e-3, each epoch's test MSE within 1% of JAX's; one GCN and one TGCN
  train step's gradients within 1e-5 * max |g| of ``jax.grad`` (each leaf
  at least 1e-3 of the largest), the encoder's nonzero;
* node paths (GC-LSTM at K = 1 and 2), one epoch, val and test: the
  interleave of snapshot steps and label batches equal, every loss within
  5e-3, val NDCG within 0.01 and test within 0.02, and the encoder
  unchanged in both packages (ROADMAP fault 22);
* a stream with windows whose only events are labels (ROADMAP fault 23):
  the same interleave as JAX's, NDCG in the same bands;
* both persistent forecasts within 1e-6;
* every example asks for the card unless given ``--device cpu``.
"""

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tgm_tpu import DGData as JDGData  # noqa: E402
from tgm_tpu import DGDataLoader as JLoader  # noqa: E402
from tgm_tpu import DGraph as JDGraph  # noqa: E402
from tgm_tpu import TimeDeltaDG as JTimeDelta  # noqa: E402
from tgm_tpu.nn import GCLSTM as JGCLSTM  # noqa: E402
from tgm_tpu_torch import DGData, weights  # noqa: E402
from tgm_tpu_torch.examples.graphproppred import gcn as graph_gcn  # noqa: E402
from tgm_tpu_torch.examples.graphproppred import persistant_forecast as graph_pf  # noqa: E402
from tgm_tpu_torch.examples.graphproppred import tgcn as graph_tgcn  # noqa: E402
from tgm_tpu_torch.examples.nodeproppred import gclstm as node_gclstm  # noqa: E402
from tgm_tpu_torch.examples.nodeproppred import gcn as node_gcn  # noqa: E402
from tgm_tpu_torch.examples.nodeproppred import persistant_forecast as node_pf  # noqa: E402
from tgm_tpu_torch.examples.nodeproppred import tgcn as node_tgcn  # noqa: E402

SEED, C = 11, 4
NODE_FLAGS = ["--epochs", "1", "--bsize", "50", "--embed-dim", "16", "--snapshot-ticks", "400",
              "--num-classes", str(C), "--seed", str(SEED)]
GRAPH_FLAGS = ["--epochs", "2", "--embed-dim", "16", "--snapshot-ticks", "200",
               "--seed", str(SEED)]
LOADERS = {"gcn": weights.load_gcn_params, "tgcn": weights.load_tgcn_params,
           "gclstm": weights.load_gclstm_params}


def graph_stream(N=120, E=3_000, t_max=12_000):
    """Edges with a skewed node activity whose rate drifts over time."""
    rng = np.random.default_rng(SEED)
    pop = rng.zipf(1.6, N).astype(np.float64)
    pop /= pop.sum()
    src = rng.choice(N, E, p=pop)
    dst = (src + 1 + rng.choice(N - 1, E)) % N
    t = np.sort((rng.random(E) ** 1.3 * t_max).astype(np.int64))
    return dict(edge_time=t, edge_index=np.stack([src, dst], 1).astype(np.int32),
                time_delta="s")


def node_stream(N=80, E=2_000, t_max=12_000, label_gap=None):
    """Edges as ``graph_stream``'s and a soft label (C classes) on the source
    of every 8th edge, at its time; with ``label_gap`` = (a, b) the edges of
    [a, b) go and labels at every 100 s of it come instead, so some
    snapshot windows hold labels alone."""
    rng = np.random.default_rng(SEED + 1)
    pop = rng.zipf(1.6, N).astype(np.float64)
    pop /= pop.sum()
    src = rng.choice(N, E, p=pop)
    dst = (src + 1 + rng.choice(N - 1, E)) % N
    t = np.sort(rng.integers(0, t_max, E))
    idx = np.arange(0, E, 8)
    y = rng.random((len(idx), C)).astype(np.float32)
    y[:, 0] += (dst[idx] % C == 0) * 2.0  # a learnable part
    yt, yn = t[idx], src[idx].astype(np.int32)
    if label_gap is not None:
        a, b = label_gap
        keep = (t < a) | (t >= b)
        src, dst, t = src[keep], dst[keep], t[keep]
        lab = (yt < a) | (yt >= b)
        gap_t = np.arange(a, b, 100)
        yt = np.concatenate([yt[lab], gap_t])
        yn = np.concatenate([yn[lab], rng.integers(0, 10, len(gap_t)).astype(np.int32)])
        y = np.concatenate([y[lab], rng.random((len(gap_t), C)).astype(np.float32)])
    return dict(edge_time=t, edge_index=np.stack([src, dst], 1).astype(np.int32),
                node_y_time=yt, node_y_nids=yn, node_y=y / y.sum(1, keepdims=True),
                time_delta="s")


class _Recorder:
    """Stands in for a JAX example's ``jax``, ``optax``, ``np`` or loader
    names: records ``adam``'s initial parameters, each jitted call's
    arguments and outputs, each ``np.mean`` and each snapshot loader."""

    def __init__(self):
        self.calls, self.params0, self.means = [], None, []

    @staticmethod
    def module_proxy(real, **overrides):
        class Proxy:
            def __getattr__(self, k):
                return overrides[k] if k in overrides else getattr(real, k)

        return Proxy()

    def jit(self, f=None, **kw):
        if f is None:
            return lambda g: self.jit(g, **kw)
        jf = jax.jit(f, **kw)

        def run(*a):
            out = jf(*a)
            self.calls.append((f.__name__, a, out))
            return out

        return run

    def adam(self, lr):
        tx = optax.adam(lr)

        def init(params):
            self.params0 = jax.tree_util.tree_map(np.asarray, params)
            return tx.init(params)

        return optax.GradientTransformation(init, tx.update)

    def mean(self, x, *a, **k):
        out = np.mean(x, *a, **k)
        self.means.append(out)
        return out

    def loader(self, *a, **k):
        if k.get("batch_unit") == "s":
            self.calls.append(("split", a, None))
        return JLoader(*a, **k)


def run_jax(module: str, argv, raw, monkeypatch, **main_kw):
    """The JAX example's ``main`` on ``raw``'s stream; returns the recorder."""
    mod = importlib.import_module(f"examples.{module}")
    rec = _Recorder()
    monkeypatch.setattr(mod, "load_dataset", lambda *a, **k: (JDGData.from_raw(**raw), None,
                                                              None))
    if hasattr(mod, "jax"):
        monkeypatch.setattr(mod, "jax", rec.module_proxy(jax, jit=rec.jit))
    if hasattr(mod, "optax"):
        monkeypatch.setattr(mod, "optax", rec.module_proxy(optax, adam=rec.adam))
    monkeypatch.setattr(mod, "np", rec.module_proxy(np, mean=rec.mean))
    monkeypatch.setattr(mod, "DGDataLoader", rec.loader)
    monkeypatch.setattr(sys, "argv", [module, *argv])
    mod.main(**main_kw)
    return rec


def state(mod):
    return {k: v.detach().clone() for k, v in mod.state_dict().items()}


def largest_move(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def tree_move(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


# ---------------------------------------------------------------------- #
# Graph property prediction
# ---------------------------------------------------------------------- #
GRAPH = {"gcn": (graph_gcn, "train_step", "predict"), "tgcn": (graph_tgcn, "step", "predict")}


@pytest.mark.parametrize("name", ["gcn", "tgcn"])
def test_graph_two_epochs_match_the_jax_example(name, monkeypatch):
    raw = graph_stream()
    rec = run_jax(f"graphproppred.{name}", GRAPH_FLAGS, raw, monkeypatch)
    mod, train_name, pred_name = GRAPH[name]
    args = mod.parse_args([*GRAPH_FLAGS, "--device", "cpu"])
    ctx = mod.build(args, data=DGData.from_raw(**raw))
    LOADERS[name](rec.params0, ctx.encoder, ctx.head)
    enc0 = state(ctx.encoder)
    out = mod.run(ctx, args)

    losses = [float(c[2][-1]) for c in rec.calls if c[0] == train_name]
    preds = [float(c[2] if name == "gcn" else c[2][0]) for c in rec.calls if c[0] == pred_name]
    n_tr, n_te = ctx.n_train, len(ctx.snapshots) - ctx.n_train
    assert len(losses) == 2 * n_tr and len(preds) == 2 * n_te and n_tr > 30 and n_te > 10
    # The JAX example's targets, from its own loader.
    coarse = JDGData.from_raw(**raw).discretize(JTimeDelta("s", 200))
    counts = np.array([float(np.asarray(b.edge_valid).sum()) for b in
                       JLoader(JDGraph(coarse), 200, batch_unit="s", materialize_features=False)])
    np.testing.assert_array_equal(ctx.targets, counts[1:] / max(counts.max(), 1.0))
    got = np.concatenate(out["losses"])
    first, worst = abs(got[0] - losses[0]), float(np.abs(got - losses).max())
    j_mse = [float(np.mean((np.asarray(preds[e * n_te:(e + 1) * n_te]) - ctx.targets[n_tr:]) ** 2))
             for e in range(2)]
    rel = [abs(a - b) / b for a, b in zip(out["test_mse"], j_mse)]
    print(f"graph {name}: {n_tr} train / {n_te} test snapshots; first-loss diff {first:.3g}, "
          f"max loss diff {worst:.3g}; train MSE {out['train_mse']}; test MSE "
          f"{out['test_mse']} (JAX {j_mse}); relative gap {rel}")
    assert first <= 1e-5 and worst <= 5e-3
    assert max(rel) <= 0.01
    # The encoder trains in both packages.
    assert largest_move(state(ctx.encoder), enc0) > 0.0
    last = [c for c in rec.calls if c[0] == train_name][-1][2][0]
    assert tree_move(last["enc"], rec.params0["enc"]) > 0.0


def _jax_graph_modules(name, node_dim, embed):
    from tgm_tpu.nn import GCN as JGCN
    from tgm_tpu.nn import TGCN as JTGCN
    from tgm_tpu.nn import GraphPredictor as JGraphPredictor

    enc = (JGCN(hidden_dim=embed, out_dim=embed, num_layers=2) if name == "gcn"
           else JTGCN(in_channels=node_dim, out_channels=embed))
    return enc, JGraphPredictor(in_dim=embed, out_dim=1)


@pytest.mark.parametrize("name", ["gcn", "tgcn"])
def test_graph_step_gradients_match_jax_grad(name):
    raw = graph_stream()
    mod = GRAPH[name][0]
    args = mod.parse_args([*GRAPH_FLAGS, "--device", "cpu"])
    ctx = mod.build(args, data=DGData.from_raw(**raw))
    enc, head = _jax_graph_modules(name, ctx.node_x.shape[1], args.embed_dim)
    node_x = jnp.asarray(ctx.node_x.numpy())
    e4 = jnp.zeros(4, jnp.int32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    params = {"enc": enc.init(k1, node_x, e4, e4), "head": head.init(k2, jnp.zeros((4, 16)))}
    LOADERS[name](params, ctx.encoder, ctx.head)
    i = ctx.n_train // 2
    b, y = ctx.snapshots[i], float(ctx.targets_d[i])
    jb = [jnp.asarray(getattr(b, f).numpy()) for f in ("edge_src", "edge_dst", "edge_valid")]
    H0 = np.random.default_rng(3).normal(size=(ctx.num_nodes, 16)).astype(np.float32) * 0.3

    def loss(p):
        if name == "gcn":
            z = enc.apply(p["enc"], node_x, jb[0], jb[1], None, jb[2])
        else:
            z = enc.apply(p["enc"], node_x, jb[0], jb[1], None, jnp.asarray(H0), jb[2])
        return (head.apply(p["head"], z)[0] - y) ** 2

    grads = jax.grad(loss)(params)
    H = torch.from_numpy(H0)
    pred = ctx.forward(b) if name == "gcn" else ctx.forward(H, b)[0]
    ((pred - ctx.targets_d[i]) ** 2).backward()
    # jax.grad's tree mapped onto a second pair of modules, leaf by leaf.
    want = mod.build(args, data=DGData.from_raw(**raw))
    LOADERS[name](grads, want.encoder, want.head)
    pairs = [(p.grad, w.detach()) for m, wm in ((ctx.encoder, want.encoder), (ctx.head, want.head))
             for p, w in zip(m.parameters(), wm.parameters())]
    floor = 1e-3 * max(float(w.abs().max()) for _, w in pairs)
    for g, w in pairs:
        assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), floor)
    assert all(float(p.grad.abs().max()) > 0 for p in ctx.encoder.parameters())


def test_graph_persistent_forecast_matches_jax(monkeypatch):
    raw = graph_stream()
    rec = run_jax("graphproppred.persistant_forecast", ["--snapshot-ticks", "200"], raw,
                  monkeypatch)
    out = graph_pf.run(graph_pf.parse_args(["--device", "cpu"]), data=DGData.from_raw(**raw))
    assert abs(out["test_mse"] - float(rec.means[-1])) <= 1e-6 and out["snapshots"] > 40


# ---------------------------------------------------------------------- #
# Node property prediction
# ---------------------------------------------------------------------- #
def _jax_gclstm_k2(args, node_dim):
    return JGCLSTM(in_channels=node_dim, out_channels=args.embed_dim, K=2)


NODE_CASES = [("gcn", []), ("tgcn", []), ("gclstm", []), ("gclstm", ["--K", "2"])]
PORT_NODE = {"gcn": (node_gcn, {}), "tgcn": (node_tgcn, node_tgcn.HOOKS),
             "gclstm": (node_gclstm, node_gclstm.HOOKS)}


def jax_node_main_kw(name, argv):
    """The hooks the JAX example's ``__main__`` passes to ``main``."""
    if name == "gcn":
        return {}
    j = importlib.import_module(f"examples.nodeproppred.{name}")
    kw = dict(make_encoder=j.make_encoder, snapshot_apply=j.snapshot_apply)
    if name == "tgcn":
        kw["init_H"] = lambda n, d: jnp.zeros((n, d))
    else:
        kw["init_H"] = lambda n, d: (jnp.zeros((n, d)), jnp.zeros((n, d)))
        if argv:  # its K is fixed at 1; the port's --K 2 against a K = 2 encoder
            kw["make_encoder"] = _jax_gclstm_k2
    return kw


def jax_node_runs(rec):
    """Per split: the interleave ("S", edges, last time) / "B", and the
    label batches' losses or NDCG."""
    runs = []
    for name, a, out in rec.calls:
        if name == "split":
            runs.append(SimpleNamespace(steps=[], vals=[]))
        elif name == "<lambda>":
            sb = a[2]
            runs[-1].steps.append(("S", int(np.asarray(sb.edge_valid).sum()),
                                   int(np.asarray(sb.edge_time).max())))
        elif name in ("train_step", "eval_step"):
            runs[-1].steps.append("B")
            runs[-1].vals.append(float(out[2] if name == "train_step" else out))
    return runs


def port_node_steps(prog):
    plan, sd = prog.snap_plan, prog.snap_data
    steps = []
    for kind, idx in zip(prog.kinds.tolist(), prog.idxs.tolist()):
        if kind == 1:
            steps.append("B")
            continue
        row = int(prog.snap_rows[idx])
        cnt, off = int(plan.edge_counts[row]), int(plan.edge_offsets[row])
        steps.append(("S", cnt, int(sd.edge_time[off + cnt - 1]) if cnt else 0))
    return steps


def run_node_case(name, argv, raw, monkeypatch):
    # The TGCN and GC-LSTM examples run the GCN example's main with their hooks.
    rec = run_jax("nodeproppred.gcn", [*NODE_FLAGS], raw, monkeypatch,
                  **jax_node_main_kw(name, argv))
    j_runs = jax_node_runs(rec)
    mod, hooks = PORT_NODE[name]
    args = mod.parse_args([*NODE_FLAGS, *argv, "--device", "cpu"])
    ctx = node_gcn.build(args, data=DGData.from_raw(**raw), **hooks)
    LOADERS[name]({"enc": rec.params0["enc"], "head": rec.params0["head"]}, ctx.encoder,
                  ctx.head)
    enc0, head0 = state(ctx.encoder), state(ctx.head)
    out = node_gcn.run(ctx, args)
    assert len(j_runs) == 3
    for split, run in zip(("train", "val", "test"), j_runs):
        assert port_node_steps(ctx.progs[split]) == run.steps, split
    # Fault 22: the encoder never moves, in either package; the head does.
    j_last = [c for c in rec.calls if c[0] == "train_step"][-1][2][0]
    assert tree_move(j_last["enc"], rec.params0["enc"]) == 0.0
    assert tree_move(j_last["head"], rec.params0["head"]) > 0.0
    assert largest_move(state(ctx.encoder), enc0) == 0.0
    assert largest_move(state(ctx.head), head0) > 0.0
    return out, j_runs, ctx


@pytest.mark.parametrize("name,argv", NODE_CASES)
def test_node_epoch_matches_the_jax_example(name, argv, monkeypatch):
    out, j_runs, ctx = run_node_case(name, argv, node_stream(), monkeypatch)
    train, val, test = j_runs
    loss_diff = float(np.abs(np.asarray(out["losses"][0]) - train.vals).max())
    val_diff = abs(out["val_ndcg"][0] - float(np.mean(val.vals)))
    test_diff = abs(out["test_ndcg"] - float(np.mean(test.vals)))
    n_snap = [sum(s != "B" for s in r.steps) for r in j_runs]
    print(f"node {name} {argv}: {len(train.vals)} train batches, snapshot steps {n_snap}; "
          f"max loss diff {loss_diff:.3g}; val NDCG {out['val_ndcg'][0]:.5f} (JAX "
          f"{np.mean(val.vals):.5f}), test {out['test_ndcg']:.5f} (JAX {np.mean(test.vals):.5f})")
    assert len(out["losses"][0]) == len(train.vals) > 10 and min(n_snap) >= 3
    assert loss_diff <= 5e-3 and val_diff <= 0.01 and test_diff <= 0.02


def test_label_only_snapshots_advance_like_jax(monkeypatch):
    """Fault 23: train-split windows of [3000, 4600) hold labels alone."""
    raw = node_stream(label_gap=(3_000, 4_600))
    out, j_runs, ctx = run_node_case("tgcn", [], raw, monkeypatch)
    empty = [s for s in j_runs[0].steps if s != "B" and s[1] == 0]
    assert len(empty) >= 3 and all(s[2] == 0 for s in empty)  # the clock falls to 0
    assert abs(out["val_ndcg"][0] - float(np.mean(j_runs[1].vals))) <= 0.01
    assert abs(out["test_ndcg"] - float(np.mean(j_runs[2].vals))) <= 0.02
    assert float(np.abs(np.asarray(out["losses"][0]) - j_runs[0].vals).max()) <= 5e-3


def test_node_persistent_forecast_matches_jax(monkeypatch):
    raw = node_stream()
    rec = run_jax("nodeproppred.persistant_forecast", ["--bsize", "50", "--num-classes", str(C)],
                  raw, monkeypatch)
    out = node_pf.run(node_pf.parse_args(["--bsize", "50", "--device", "cpu"]),
                      data=DGData.from_raw(**raw))
    assert list(out) == ["train", "val", "test"] and len(rec.means) == 3
    for got, want in zip(out.values(), rec.means):
        assert abs(got - float(want)) <= 1e-6


# ---------------------------------------------------------------------- #
# Entry points
# ---------------------------------------------------------------------- #
EXAMPLES = [node_gcn, node_tgcn, node_gclstm, node_pf, graph_gcn, graph_tgcn, graph_pf]


@pytest.mark.parametrize("mod", EXAMPLES, ids=lambda m: m.__name__.split("examples.")[1])
def test_examples_run_on_the_card_unless_asked_for_the_cpu(mod):
    """Without ``--device`` an example asks for the card; without a card it raises."""
    assert mod.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            mod.main(["--dataset", "synthetic-60-300"])
