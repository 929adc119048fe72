"""The parameter-free baselines against the JAX package, batch by batch.

EdgeBank (unlimited and fixed), PopTrack and t-CoMem are built from the
same numpy edges in both packages and fed the same batches; the port gets
each batch whole, its padding rows (PAD ids, time 0) included, and the JAX
package its valid rows, as the examples call them, apart from EdgeBank,
which both packages get whole: it keys every row as the JAX package does
(ROADMAP fault 24, resolved). After the constructor and after every
update the states compare exactly: EdgeBank's stored keys with their
latest times, its key base and its window; PopTrack's popularity; t-CoMem's
rings, cursors, lengths, popularity, co-occurrence counts and window. Each
batch's queries (its sources against random candidates, padded rows
included) score bit for bit alike for EdgeBank and PopTrack, and within
1e-6 * max |score| for t-CoMem (its ``exp`` may differ by an ulp; the
number of bit-equal scores is printed).

Streams: a hot-node one (zipf ids, small times), one with epoch-second
times (t0 = 1.5e9, where a float32 window comparison answers wrongly),
one whose ids grow after the constructor (JAX's key base grows), and one
heavy in self-loops. EdgeBank's queries include the padded rows' (PAD,
PAD) and (PAD, candidate) pairs, which JAX's composite key may alias onto
a stored key; the port answers them alike (fault 24's own test pins a
case).
"""

import numpy as np
import pytest
import torch

from tgm_tpu.nn.modules.edgebank import EdgeBankPredictor as JEdgeBank
from tgm_tpu.nn.modules.poptrack import PopTrackPredictor as JPopTrack
from tgm_tpu.nn.modules.t_comem import tCoMemPredictor as JTCoMem
from tgm_tpu_torch.nn.modules.edgebank import EdgeBankPredictor
from tgm_tpu_torch.nn.modules.pair_table import SENTINEL, SortedPairTable, pair_keys
from tgm_tpu_torch.nn.modules.poptrack import PopTrackPredictor
from tgm_tpu_torch.nn.modules.t_comem import pairwise_row_sum, tCoMemPredictor

PAD = -1
N, E, B, Q = 80, 2400, 64, 6
CPU = torch.device("cpu")


def make_stream(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "grow":
        # The constructor's edges touch ids < 20; later batches reach N - 1.
        lim = np.where(np.arange(E) < E // 3, 20, N)
        src = (rng.random(E) * lim).astype(np.int64)
        dst = (rng.random(E) * lim).astype(np.int64)
    else:
        p = rng.zipf(1.5, N).astype(np.float64)
        p /= p.sum()
        src = rng.choice(N, E, p=p)
        dst = rng.choice(N, E, p=p)
    if kind == "selfloop":
        dst = np.where(rng.random(E) < 0.3, src, dst)
    t = np.sort(rng.integers(0, 4 * E, E))
    if kind == "epoch":
        t = 1_500_000_000 + np.sort(rng.integers(0, 3 * E, E))
    return src, dst, t


def batches(src, dst, t, start: int):
    """The stream past ``start`` in batches of B, the last padded as the
    port's streams pad it: (valid rows, padded rows)."""
    for lo in range(start, len(src), B):
        s, d, tt = src[lo : lo + B], dst[lo : lo + B], t[lo : lo + B]
        pad = B - len(s)
        padded = (np.concatenate([s, np.full(pad, PAD)]), np.concatenate([d, np.full(pad, PAD)]),
                  np.concatenate([tt, np.zeros(pad, np.int64)]))
        yield (s, d, tt), padded


def queries(rng, s_pad):
    """Each padded row's source against Q random candidates (PAD on padded rows)."""
    qs = np.repeat(s_pad, Q)
    qd = rng.integers(0, N, len(qs))
    return qs, np.where(qs == PAD, PAD, qd)


def decode(keys):
    keys = keys.cpu().numpy()
    return keys >> 32, keys & 0xFFFFFFFF


def edgebank_state(p: EdgeBankPredictor, j: JEdgeBank):
    j._merge_pending()
    last = np.r_[j._keys[1:] != j._keys[:-1], True]  # the run's last entry: its latest time
    keys, vals = p.memory.items()
    np.testing.assert_array_equal(np.stack([keys.numpy(), vals.numpy()]),
                                  np.stack([j._keys[last], j._times[last]]))
    assert p._pair_base == j._pair_base
    assert (p.window_start, p.window_end) == (j.window_start, j.window_end)


def tcomem_state(p: tCoMemPredictor, j: JTCoMem):
    for name in ("recent_ts", "recent_dst", "recent_len", "recent_pos", "popularity"):
        got, want = getattr(p, name).numpy(), getattr(j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    jc = sorted((s, d, c) for s, row in j.node_to_co_occurrence.items() for d, c in row.items())
    keys, vals = p.co_occurrence.items()
    ps, pd = decode(keys)
    np.testing.assert_array_equal(np.stack([ps, pd, vals.numpy()]), np.array(jc).T)
    assert (p.window_start, p.window_end, p.window_size) == \
           (j.window_start, j.window_end, j.window_size)


def poptrack_state(p: PopTrackPredictor, j: JPopTrack):
    np.testing.assert_array_equal(p.popularity.numpy(), j.popularity)


MODELS = {
    "edgebank-unlimited": (EdgeBankPredictor, JEdgeBank, {}, edgebank_state),
    "edgebank-fixed": (EdgeBankPredictor, JEdgeBank, dict(memory_mode="fixed", window_ratio=0.15),
                       edgebank_state),
    "poptrack": (PopTrackPredictor, JPopTrack, dict(num_nodes=N, k=10, decay=0.9),
                 poptrack_state),
    "tcomem": (tCoMemPredictor, JTCoMem, dict(num_nodes=N, k=7, window_ratio=0.15,
                                              co_occurrence_weight=0.8), tcomem_state),
}


@pytest.mark.parametrize("stream", ["zipf", "epoch", "grow", "selfloop"])
@pytest.mark.parametrize("model", list(MODELS))
def test_predictor_matches_jax_batch_by_batch(model, stream):
    cls, jcls, kw, state = MODELS[model]
    src, dst, t = make_stream(stream)
    n0 = E // 3
    p = cls(src[:n0], dst[:n0], t[:n0], device=CPU, **kw)
    j = jcls(src[:n0], dst[:n0], t[:n0], **kw)
    state(p, j)
    rng = np.random.default_rng(1)
    worst, n_equal, n_scores = 0.0, 0, 0
    for (s, d, tt), (ps, pd, pt) in batches(src, dst, t, n0):
        qs, qd = queries(rng, ps)
        if model.startswith("edgebank"):
            # Both packages key every row alike: JAX gets the padded batch too.
            s, d, tt = ps, pd, pt
            qd[rng.random(len(qd)) < 0.1] = PAD  # (src, PAD) queries too
        got, want = p(qs, qd), j(qs, qd)
        assert got.dtype == torch.float32 and got.device == CPU
        got = got.numpy()
        if model == "tcomem":
            gap = float(np.abs(got - want).max())
            assert gap <= 1e-6 * max(float(np.abs(want).max()), 1.0), gap
            worst = max(worst, gap)
            n_equal += int((got == want).sum())
            n_scores += got.size
        else:
            np.testing.assert_array_equal(got, want)
        p.update(torch.as_tensor(ps), torch.as_tensor(pd), torch.as_tensor(pt))
        j.update(s, d, tt)
        state(p, j)
    if model == "tcomem":
        print(f"t-CoMem {stream}: {n_equal} of {n_scores} scores bit-equal, max gap {worst:.3g}")


def test_fixed_window_compares_in_fp64_at_epoch_seconds():
    """A pair last seen 1 s before the window start is out of the window.
    In float32 both times round to 1,500,000,128, which would let it in."""
    t0 = 1_500_000_000
    src, dst, t = [0, 1, 2], [5, 6, 7], [t0, t0 + 84, t0 + 100]
    p = EdgeBankPredictor(src, dst, t, memory_mode="fixed", window_ratio=0.15, device=CPU)
    j = JEdgeBank(np.array(src), np.array(dst), np.array(t), memory_mode="fixed",
                  window_ratio=0.15)
    assert p.window_start == j.window_start == t0 + 85
    assert np.float32(t0 + 84) >= np.float32(p.window_start)  # the trap float32 falls in
    np.testing.assert_array_equal(p([0, 1, 2], [5, 6, 7]).numpy(), [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(j(np.array([0, 1, 2]), np.array([5, 6, 7])), [0.0, 0.0, 1.0])

    # t-CoMem's window: a ring entry 1 s before the window start adds nothing.
    tc = tCoMemPredictor([0, 0], [1, 2], [t0, t0 + 84], num_nodes=4, k=2, device=CPU)
    jtc = JTCoMem(np.array([0, 0]), np.array([1, 2]), np.array([t0, t0 + 84]), num_nodes=4, k=2)
    for m in (tc, jtc):
        m.update(np.array([3]), np.array([3]), np.array([t0 + 169]))  # start moves to t0 + 85
    assert tc.window_start == jtc.window_start == t0 + 85
    np.testing.assert_array_equal(tc([0, 3], [1, 3]).numpy(), jtc(np.array([0, 3]), np.array([1, 3])))
    assert float(tc([0], [3])[0]) == 0.0  # (0, 3) never co-occurred; its ring is out of window


@pytest.mark.parametrize("kw", [dict(memory_mode="fixed"), {}])
def test_fault_24_padded_query_aliases_in_jax_only(kw):
    """ROADMAP fault 24, resolved: JAX keys (src, dst) as src * base + dst,
    so the query (1, -1) reads the key of (0, 9), and the port keys it the
    same way: both answer 1.0. So do negative ids in updates (stored under
    their aliasing keys) and queries whose ids raise the base (every key is
    re-keyed, and keys that meet keep their latest time)."""
    j = JEdgeBank(np.array([0, 3]), np.array([9, 4]), np.array([1, 2]), **kw)
    p = EdgeBankPredictor([0, 3], [9, 4], [1, 2], device=CPU, **kw)
    hit = 0.0 if kw else 1.0  # fixed: (0, 9) at t = 1 is before the window
    assert j(np.array([1]), np.array([-1]))[0] == hit
    assert float(p([1], [-1])[0]) == hit
    qs, qd = np.array([0, 3, 1, -1, 2, -1, 5]), np.array([9, 4, 9, 9, -1, -1, 4])
    np.testing.assert_array_equal(p(qs, qd).numpy(), j(qs, qd))
    for s, d, t in (([2, -1, 5], [-3, -1, 0], [4, 0, 6]), ([-2, 7], [12, -1], [3, 9]),
                    ([1, 30], [-1, 2], [10, 11])):
        p.update(s, d, t)
        j.update(np.array(s), np.array(d), np.array(t))
        edgebank_state(p, j)
        qs = np.arange(-2, 40) % 33 - 2
        qd = (np.arange(-2, 40) * 7) % 35 - 2
        np.testing.assert_array_equal(p(qs, qd).numpy(), j(qs, qd))
        edgebank_state(p, j)  # the queries' ids may raise the base


@pytest.mark.parametrize("kw", [dict(memory_mode="fixed"), {}])
def test_update_skips_padding_rows(kw):
    """EdgeBank stores a padded batch's rows as the JAX EdgeBank does (PAD
    rows keyed too, fault 24 resolved), and a query of the padded key hits
    in both; PopTrack and t-CoMem update with a padded batch as with its
    valid rows alone."""
    a = EdgeBankPredictor([0, 1], [1, 2], [1, 2], device=CPU, **kw)
    j = JEdgeBank(np.array([0, 1]), np.array([1, 2]), np.array([1, 2]), **kw)
    # A query first, as the examples make one: the JAX update below raises
    # the key base, and with keys still pending it would drop its own keys
    # (ROADMAP fault 27).
    np.testing.assert_array_equal(a([0], [1]).numpy(), j(np.array([0]), np.array([1])))
    a.update([2, -1, -1], [3, -1, -1], [9, 0, 0])
    j.update(np.array([2, -1, -1]), np.array([3, -1, -1]), np.array([9, 0, 0]))
    edgebank_state(a, j)
    qs, qd = np.array([2, -1, -1, 0, 1]), np.array([3, -1, 3, 1, 0])
    np.testing.assert_array_equal(a(qs, qd).numpy(), j(qs, qd))
    assert float(a([-1], [-1])[0]) == (1.0 if not kw else 0.0)  # t = 0 is out of the window
    pa = PopTrackPredictor([0], [1], [1], num_nodes=4, k=1, device=CPU)
    pb = PopTrackPredictor([0], [1], [1], num_nodes=4, k=1, device=CPU)
    pa.update([2, -1], [0, -1], [3, 0])
    pb.update([2], [0], [3])
    assert torch.equal(pa.popularity, pb.popularity)
    ta = tCoMemPredictor([0], [1], [1], num_nodes=4, k=2, device=CPU)
    tb = tCoMemPredictor([0], [1], [1], num_nodes=4, k=2, device=CPU)
    ta.update([2, -1, 3], [0, -1, 3], [3, 0, 4])
    tb.update([2, 3], [0, 3], [3, 4])
    for name in ("recent_ts", "recent_dst", "recent_len", "recent_pos", "popularity"):
        assert torch.equal(getattr(ta, name), getattr(tb, name)), name
    for x, y in zip(ta.co_occurrence.items(), tb.co_occurrence.items()):
        assert torch.equal(x, y)


VALIDATION = [
    ("edgebank", dict(memory_mode="lru")),
    ("edgebank", dict(window_ratio=0.0)),
    ("edgebank", dict(window_ratio=1.5)),
    ("edgebank", dict(dst=[1])),
    ("edgebank", dict(src=[], dst=[], ts=[])),
    ("poptrack", dict(k=0)),
    ("poptrack", dict(decay=0.0)),
    ("poptrack", dict(decay=1.5)),
    ("poptrack", dict(num_nodes=0)),
    ("poptrack", dict(k=9)),
    ("poptrack", dict(ts=[1])),
    ("poptrack", dict(src=[], dst=[], ts=[])),
    ("tcomem", dict(window_ratio=0.0)),
    ("tcomem", dict(co_occurrence_weight=0.0)),
    ("tcomem", dict(co_occurrence_weight=1.5)),
    ("tcomem", dict(k=0)),
    ("tcomem", dict(num_nodes=0)),
    ("tcomem", dict(k=9)),
    ("tcomem", dict(src=[0])),
    ("tcomem", dict(src=[], dst=[], ts=[])),
]


@pytest.mark.parametrize("model,kw", VALIDATION)
def test_constructor_validation_raises_like_jax(model, kw):
    base = dict(src=[0, 1], dst=[1, 2], ts=[1, 2])
    if model != "edgebank":
        base.update(num_nodes=8, k=2)
    base.update(kw)
    cls, jcls = {"edgebank": (EdgeBankPredictor, JEdgeBank), "poptrack": (PopTrackPredictor, JPopTrack),
                 "tcomem": (tCoMemPredictor, JTCoMem)}[model]
    jargs = {k: (np.asarray(v, dtype=np.int64) if k in ("src", "dst", "ts") else v)
             for k, v in base.items()}
    with pytest.raises(ValueError) as j_err:
        jcls(**jargs)
    with pytest.raises(ValueError, match=str(j_err.value).replace("(", r"\(").replace(")", r"\)")):
        cls(device=CPU, **base)


@pytest.mark.parametrize("cls,kw", [(EdgeBankPredictor, {}), (PopTrackPredictor, dict(num_nodes=4, k=2)),
                                    (tCoMemPredictor, dict(num_nodes=4, k=2))])
def test_default_device_is_the_card(cls, kw):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls([0], [1], [1], **kw)


@pytest.mark.parametrize("n", [1, 5, 7, 8, 9, 16, 50, 129, 300])
def test_pairwise_row_sum_is_numpy_sum(n):
    rng = np.random.default_rng(n)
    x = rng.random((300, n)) * np.exp(rng.normal(size=(300, n)) * 4)
    np.testing.assert_array_equal(pairwise_row_sum(torch.from_numpy(x)).numpy(), x.sum(axis=1))


@pytest.mark.parametrize("reduce", ["sum", "amax"])
def test_pair_table_against_a_dict(reduce):
    """Merges of random batches (negative ids skipped) past several growths
    of the capacity; the table equals a dict after every merge."""
    rng = np.random.default_rng(3)
    table, ref = SortedPairTable(CPU, 4), {}
    for _ in range(120):
        m = int(rng.integers(1, 40))
        s, d, v = rng.integers(-1, 30, m), rng.integers(-1, 30, m), rng.integers(0, 100, m)
        table.merge(pair_keys(torch.as_tensor(s), torch.as_tensor(d)), torch.as_tensor(v), reduce)
        for a, b, c in zip(s.tolist(), d.tolist(), v.tolist()):
            if a >= 0 and b >= 0:
                k = (a << 32) | b
                ref[k] = (ref.get(k, 0) + c) if reduce == "sum" else max(ref.get(k, c), c)
        keys, vals = table.items()
        assert keys.tolist() == sorted(ref)
        assert vals.tolist() == [ref[k] for k in sorted(ref)]
    q = pair_keys(torch.tensor([0, 29, -1, 5]), torch.tensor([0, 29, 3, -1]))
    hit, row = table.lookup(q)
    assert q[2] == SENTINEL and not hit[2] and not hit[3]
    assert hit[:2].tolist() == [((0 << 32) | 0) in ref, ((29 << 32) | 29) in ref]
    # Reads of the size: one per capacity check past the bound, plus the items() calls.
    assert table.capacity >= 2 * len(ref) and table.size_reads < 120 + 20


def test_poptrack_scores_an_id_past_the_table_zero():
    """A TGB candidate may name a node no edge touches, past ``num_nodes``:
    numpy raises on it, the port scores it 0 (a node never seen has no
    popularity). Negative ids read from the end in both."""
    j = JPopTrack(np.array([0, 1]), np.array([1, 2]), np.array([1, 2]), num_nodes=3, k=1)
    p = PopTrackPredictor([0, 1], [1, 2], [1, 2], num_nodes=3, k=1, device=CPU)
    with pytest.raises(IndexError):
        j(np.array([0]), np.array([3]))
    np.testing.assert_array_equal(p([0, 0, 0, 0], [3, 7, -1, -3]).numpy(),
                                  [0.0, 0.0] + j(np.zeros(2, np.int64), np.array([-1, -3])).tolist())
