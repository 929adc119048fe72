"""Two A/B timings on the card for the port's MLP-Mixer models.

1. TPNet's pairwise random-projection features in the JAX package's three
   layouts: ``rows`` (per pair, the (F, F) products of its stacked (F, dim)
   projections) and ``lanes`` (the pair axis last, one transpose at the
   end), both copied here, against ``factored_lanes`` (the self blocks once
   per node over the whole state, gathered; only the cross block per pair:
   the port's ``RandomProjectionModule.pair_features``). Timed alone at the
   eval candidate call's 160,000 pairs, over TPNet link eval batches
   (``eval_core``) and over train batches (``train_core``).
2. The MLP-Mixer's LayerNorm: flax's formula, E[x²] - E[x]², written out in
   PyTorch here, against ``nn.LayerNorm`` (one fused kernel, two-pass
   variance: the port's), over GraphMixer and TPNet train batches.

    python3 scripts/torch_mixer_ab.py [--reps 40] [--device cuda] [--dataset NAME]

The examples run at their defaults on ``chip_smoke.py``'s stream (or on
``--dataset``), TF32 off; the train split first runs through the hooks
alone so that val's recency rows are real. The variants alternate call by
call (the order reversed every other round) after one warm-up call each.
Each call is timed with CUDA events around it (the host clock on the
CPU); the script prints each variant's median, minimum and maximum ms, the
largest gap of its output from the first variant's, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import copy
import os
import statistics
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (its stream and the examples' default flags)
from tgm_tpu_torch.examples import _linkpred_common as lp  # noqa: E402
from tgm_tpu_torch.examples.linkproppred import graphmixer as gm  # noqa: E402
from tgm_tpu_torch.examples.linkproppred import tpnet as tp_link  # noqa: E402
from tgm_tpu_torch.nn.encoder.tpnet import RandomProjectionModule  # noqa: E402

EVAL_PAIRS = 160_000  # the eval candidate call: 2 * B * Q rows of K = 20 neighbours


def _rows_layout(self, state, src, dst):
    """The JAX package's ``rows`` layout (``concat_src_dst``, scaled)."""
    P = state.projections
    rp = torch.cat([P[:, self._rows(src)], P[:, self._rows(dst)]]).transpose(0, 1)
    feat = torch.einsum("bld,bmd->blm", rp, rp).reshape(src.shape[0], -1)
    return torch.log(feat.clamp_min(0.0) + 1.0)


def _lanes_layout(self, state, src, dst):
    """The JAX package's ``lanes`` layout (``concat_src_dst``, scaled)."""
    P = state.projections
    rp = torch.cat([P[:, self._rows(src)], P[:, self._rows(dst)]])  # (F, P, dim)
    feat = torch.einsum("lbd,mbd->lmb", rp, rp).reshape(-1, src.shape[0])
    return torch.log(feat.clamp_min(0.0) + 1.0).T


LAYOUTS = {"rows": _rows_layout, "lanes": _lanes_layout,
           "factored_lanes": RandomProjectionModule.pair_features}


def _flax_norm(self, x):
    """flax ``nn.LayerNorm``'s formula: ``(x - E[x]) * rsqrt(E[x²] - E[x]²
    + eps) * scale + bias``, the variance clipped at 0."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def set_layout(name):
    RandomProjectionModule.pair_features = LAYOUTS[name]


def norm_setter(encoder):
    """Sets every ``nn.LayerNorm`` of ``encoder`` to flax's formula
    ("flax_formula") or back to the fused kernel ("nn.LayerNorm")."""
    norms = [m for m in encoder.modules() if isinstance(m, torch.nn.LayerNorm)]

    def setter(name):
        for m in norms:
            if name == "flax_formula":
                m.forward = types.MethodType(_flax_norm, m)
            else:
                m.__dict__.pop("forward", None)

    return setter


def timed(dev, fn):
    """(ms, fn()) with CUDA events on the card, the host clock on the CPU,
    and the peak allocation during the call (0 on the CPU)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def ab(label, names, setter, inputs, call, probe, reps, dev, card):
    """Time ``call(x)`` for each variant over ``inputs`` (cycled), then
    compare ``probe()`` of each variant with the first's."""
    ms = {n: [] for n in names}
    rise = {n: [] for n in names}
    for n in names:
        setter(n)
        timed(dev, lambda: call(inputs[0]))
    for r in range(reps):
        x = inputs[r % len(inputs)]
        for n in (names if r % 2 == 0 else names[::-1]):
            setter(n)
            t, _, gib = timed(dev, lambda: call(x))
            ms[n].append(t)
            rise[n].append(gib)
    outs = {}
    for n in names:
        setter(n)
        with torch.no_grad():
            outs[n] = probe().float().cpu()
    ref = outs[names[0]]
    scale = max(float(ref.abs().max()), 1e-30)
    for n in names:
        gap = float((outs[n] - ref).abs().max()) / scale
        print(f"[{label}] {n}: median {statistics.median(ms[n]):.3f} ms, min {min(ms[n]):.3f}, "
              f"max {max(ms[n]):.3f} over {reps} calls; peak rise over the call's start "
              f"{max(rise[n]):.3f} GiB; output {gap:.3g} * max from {names[0]}'s [{card}]",
              flush=True)
    setter(names[0])


def hook_batches(ctx, split, first, n):
    """Batches ``first``..``first + n - 1`` of ``split`` through its hooks
    (fewer, and from an earlier one, where the split is short)."""
    total = ctx.streams[split].num_batches
    n = min(n, total)
    first = min(first, total - n)
    fn, states = ctx.hm.as_transform(split, ctx.dgs[split])
    out = []
    for i in range(first + n):
        states, batch = fn(states, ctx.streams[split].batch_at(i))
        if i >= first:
            out.append(batch)
    ctx.hm.adopt_states(split, states)
    return out


def build(ex, args_fn, seed, dev, data, cands):
    args = args_fn(seed, dev)
    if data is None:
        args.dataset = cands
        return ex.build(args)
    return ex.build(args, data=copy.copy(data), cands=(cands["val"], cands["test"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dataset", default=None,
                    help="an example dataset (synthetic-N-E) in place of the smoke's stream")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_mixer_ab.py: no card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.nvidia_smi() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    if args.dataset is None:
        data, _, _, _, cands = smoke.build_stream(args.seed)
    else:
        data, cands = None, args.dataset
    nb = min(args.reps, 20)

    # 1. TPNet's pair layouts.
    tp = build(tp_link, smoke.tpnet_args, args.seed, dev, data, cands)
    train = hook_batches(tp, "train", 50, nb)
    tp.hm.reset_state()
    lp.run_split(tp.setup, "train", lambda batch: torch.zeros(()))
    val = hook_batches(tp, "val", 0, nb)
    rp, state = tp.rp, tp.rp_state0
    for b in train:  # a state that has seen edges
        state = rp.update(state, b.edge_src, b.edge_dst, b.edge_time, b.edge_valid)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    n = rp.num_nodes
    pairs = [(torch.randint(-1, n, (EVAL_PAIRS,), generator=g, device=dev),
              torch.randint(0, n, (EVAL_PAIRS,), generator=g, device=dev)) for _ in range(nb)]
    names = list(LAYOUTS)
    ab("pairs", names, set_layout, pairs,
       lambda p: rp(state, *p), lambda: rp.pair_features(state, *pairs[0]), args.reps, dev,
       card)
    ab("tpnet-eval", names, set_layout, val, lambda b: tp.eval_core(state, b),
       lambda: rp(state, *pairs[0]), args.reps, dev, card)
    ab("tpnet-train", names, set_layout, train,
       lambda b: tp.train_core((tp.generator, state), b), lambda: rp(state, *pairs[0]),
       args.reps, dev, card)

    # 2. The mixer's LayerNorm, on a train batch of each model.
    z_tp = lambda: tp.encoder(tp.setup.node_x, train[0].edge_src, train[0].edge_dst,  # noqa: E731
                              train[0].edge_time, *_pair_rows(train[0]), state)[0]
    norms = ["flax_formula", "nn.LayerNorm"]
    ab("tpnet-train-norm", norms, norm_setter(tp.encoder), train,
       lambda b: tp.train_core((tp.generator, state), b), z_tp, args.reps, dev, card)
    del tp, train, val, pairs
    mx = build(gm, smoke.mixer_args, args.seed, dev, data, cands)
    train = hook_batches(mx, "train", 50, nb)
    ab("mixer-train-norm", norms, norm_setter(mx.encoder), train,
       lambda b: mx.train_core((mx.generator,), b), lambda: mx.eval_core.embed(train[0]),
       args.reps, dev, card)
    return 0


def _pair_rows(batch):
    """The (src, dst) call's (2B, K) neighbour rows, as ``train_core`` takes
    them."""
    from tgm_tpu_torch.train.programs import _pair_rows as rows

    return rows(batch, 0, 1)


if __name__ == "__main__":
    sys.exit(main())
