"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels) and
carry the ``cuda`` marker; without a card they skip. On the card:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (the
repo's conftest imports JAX, which the machine with the card need not have).
Tolerances: exact equality for K1-K4 and the recency push (integer select,
plan and scatter, fp32 feature copy); K5 within 5e-3 * max |plain| (bf16 operands rounded at the
same places, fp32 sums in another order: a bf16 rounding that flips moves
its sequence by up to a few 1e-3). The segment path's PyTorch ops on the
card against the CPU: ``DeduplicationHook`` exact, segment sums within
1e-6 relative (``index_add`` sums in another order on the card).
"""

import numpy as np
import pytest
import torch

from tgm_tpu_torch.hooks.neighbors import recency_eid_init, recency_eid_update
from tgm_tpu_torch.nn import TGNMemoryState
from tgm_tpu_torch.ops import (
    recency_eid_select,
    recency_eid_select_plain,
    recency_feats_select,
    recency_feats_select_plain,
    recency_push,
    recency_push_plain,
    recency_window_select,
    recency_window_select_eid,
    recency_window_select_eid_plain,
    recency_window_select_plain,
    scatter_cells,
    scatter_cells_plain,
    tgn_store_commit,
    tgn_store_commit_plain,
    tgn_store_scatter_1d,
    tgn_store_scatter_1d_plain,
    stack_weights,
    transformer_stack_fwd,
    transformer_stack_fwd_plain,
)
from tgm_tpu_torch.ops.dyg_transformer import transformer_stack_occupancy, transformer_stack_stage_ms

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def ring_rows(seed, num_nodes=200, buf=10, pushes=12, width=64):
    """Gathered ring rows (with an invalid-seed dump row) left by a CPU push stream."""
    rng = np.random.default_rng(seed)
    state = recency_eid_init(num_nodes, buf, "cpu")
    t0 = 0
    for i in range(pushes):
        src = torch.as_tensor(rng.integers(0, num_nodes - 20, width), dtype=torch.int32)
        dst = torch.as_tensor(rng.integers(0, num_nodes - 20, width), dtype=torch.int32)
        t = torch.as_tensor(np.sort(rng.integers(t0, t0 + 5, width)), dtype=torch.int32)
        t0 += 5
        eids = torch.arange(i * width, (i + 1) * width, dtype=torch.int32)
        state = recency_eid_update(state, src, dst, t, eids, None, False)
    seeds = rng.integers(-1, num_nodes + 2, 700)
    rows = np.where((seeds >= 0) & (seeds < num_nodes), seeds, num_nodes)
    qt = torch.as_tensor(rng.integers(0, t0 + 3, 700), dtype=torch.int32)
    return [x[torch.as_tensor(rows)] for x in state] + [qt]


@pytest.mark.parametrize("k", [1, 3, 10])
def test_recency_select_kernel_matches_plain(card, k):
    args = [a.to(card) for a in ring_rows(seed=k)]
    before = recency_window_select_eid.launches
    got = recency_window_select_eid(*args, k)
    assert recency_window_select_eid.launches == before + 1
    want = recency_window_select_eid_plain(*args, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        recency_window_select_eid(*args, 11)  # k > B


@pytest.mark.parametrize("k", [1, 8, 20])
def test_recency_select_kernel_matches_plain_on_unordered_rows(card, k):
    """Ring rows in no time order: K1 and its plain version both follow the
    Pallas kernels' rank rule, so they agree on these too."""
    rng = np.random.default_rng(k)
    S, B = 900, 20
    up = lambda x: torch.as_tensor(x, device=card)
    args = (up(rng.integers(-1, 9, (S, B)).astype(np.int32)),
            up(rng.integers(0, 30, (S, B)).astype(np.int32)),
            up(rng.integers(0, 10**6, (S, B)).astype(np.int32)),
            up(rng.integers(0, 5 * B, S).astype(np.int32)),
            up(rng.integers(0, 35, S).astype(np.int32)))
    got = recency_window_select_eid(*args, k)
    want = recency_window_select_eid_plain(*args, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scatter_kernels_match_plain(card):
    rng = np.random.default_rng(0)
    N1, B, E = 301, 10, 400
    buf = torch.as_tensor(rng.integers(-1, 99, (N1, B)), dtype=torch.int32, device=card)
    flat = rng.choice((N1 - 1) * B, E, replace=False)
    rows = np.where(rng.random(E) < 0.2, N1 - 1, flat // B)
    rows, cols, vals = (torch.as_tensor(x, dtype=torch.int32, device=card)
                        for x in (rows, flat % B, rng.integers(0, 9999, E)))
    before = scatter_cells.launches
    got = scatter_cells(buf.clone(), rows, cols, vals)
    assert scatter_cells.launches == before + 1
    assert torch.equal(got, scatter_cells_plain(buf.clone(), rows, cols, vals))

    stores = [torch.as_tensor(rng.integers(-1, 99, N1), dtype=torch.int32, device=card)
              for _ in range(4)]
    ups = []
    for _ in range(2):
        r = rng.choice(N1 - 1, 200, replace=False)
        r[rng.random(200) < 0.3] = N1 - 1
        ups += [torch.as_tensor(x, dtype=torch.int32, device=card)
                for x in (r, rng.integers(0, 99, 200), rng.integers(0, 9999, 200))]
    a, b = [s.clone() for s in stores], [s.clone() for s in stores]
    before = tgn_store_scatter_1d.launches
    tgn_store_scatter_1d(*a, *ups, last_live_row=N1 - 2)
    assert tgn_store_scatter_1d.launches == before + 1
    tgn_store_scatter_1d_plain(*b, *ups, N1 - 2)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("E2", [2, 400, 8192])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("B, D", [(10, 0), (20, 172), (20, 7)])  # D = 0: the eid layout
def test_recency_push_kernel_matches_plain(card, B, D, directed, E2):
    """Pushes with heavy node repetition (a pool of E2 / 40 nodes, so a node
    has up to ~40 events and r >= B drops occur), invalid events, time ties
    out of order and events at the last live node, into a state with random
    contents, the dump row included: kernel and plain version agree on all
    four tensors, the dump row is untouched, two runs are bit-equal, and a
    push is two launches. D = 7 takes the scalar feature copy."""
    rng = np.random.default_rng(E2 + D + directed)
    num_nodes, N1 = 300, 301
    E = E2 if directed else E2 // 2
    up = lambda x: torch.as_tensor(x, device=card)
    state = [up(rng.integers(-1, num_nodes, (N1, B)).astype(np.int32)),
             up(rng.integers(0, 99, (N1, B)).astype(np.int32)),
             up(rng.normal(size=(N1, B, D)).astype(np.float32)) if D else
             up(rng.integers(-1, 999, (N1, B)).astype(np.int32)),
             up(rng.integers(0, 50, N1).astype(np.int32))]
    pool = rng.choice(num_nodes, max(2, E2 // 40), replace=False)
    pool[0] = num_nodes - 1
    src, dst = (rng.choice(pool, E).astype(np.int32) for _ in range(2))
    cols = [up(src), up(dst), up(rng.integers(100, 100 + max(2, E // 8), E).astype(np.int32)),
            up(rng.normal(size=(E, D)).astype(np.float32)) if D else
            up(rng.integers(0, 10**6, E).astype(np.int32)),
            up(rng.random(E) > 0.1)]
    fresh = lambda: [x.clone() for x in state]
    got, again, want = fresh(), fresh(), fresh()
    before = recency_push.launches
    recency_push(*got, *cols, directed)
    assert recency_push.launches == before + 2
    recency_push(*again, *cols, directed)
    recency_push_plain(*want, *cols, directed)
    torch.cuda.synchronize()
    for g, a, w, s in zip(got, again, want, state):
        assert torch.equal(g, w) and torch.equal(g, a)
        assert torch.equal(g[N1 - 1], s[N1 - 1])  # the dump row
    if E2 >= 400:  # some node kept only B of its events
        kept = (got[3] - state[3]).cpu()
        assert int(kept.max()) == B and int((kept > 0).sum()) > 1


@pytest.mark.parametrize("E, R", [(200, 172), (8192, 172), (2500, 7), (200, 0), (1, 172)])
def test_store_commit_kernel_matches_plain(card, E, R):
    """The TGN message-store commit into a state with random contents (the
    dump row included): owners from a pool of E / 8 nodes (the last live one
    among them), tied and unsorted times with some below -1, 20% invalid
    events, self-loops and valid owners outside [0, N1 - 2]. Kernel and
    plain version agree on all ten fields, the dump row and mem/last_update
    are untouched, two runs are bit-equal, and a commit is one launch. R = 7
    takes the scalar row copy; E = 2,500 crosses a 1,024-event tile."""
    rng = np.random.default_rng(E + R)
    num_nodes, N1 = 9227, 9228
    up = lambda x: torch.as_tensor(x, device=card)
    ints = lambda lo, hi: up(rng.integers(lo, hi, N1).astype(np.int32))
    state = TGNMemoryState(
        mem=up(rng.normal(size=(N1, 4)).astype(np.float32)), last_update=ints(0, 99),
        s_other=ints(-1, num_nodes), s_t=ints(0, 99),
        s_raw=up(rng.normal(size=(N1, R)).astype(np.float32)), s_valid=up(rng.random(N1) < 0.5),
        d_other=ints(-1, num_nodes), d_t=ints(0, 99),
        d_raw=up(rng.normal(size=(N1, R)).astype(np.float32)), d_valid=up(rng.random(N1) < 0.5))
    pool = rng.choice(num_nodes, max(2, E // 8), replace=False)
    pool[0] = num_nodes - 1
    src, dst = (rng.choice(pool, E).astype(np.int32) for _ in range(2))
    loop = rng.random(E) < 0.05
    dst[loop] = src[loop]
    bad = rng.random(E) < 0.02
    src[bad] = rng.choice([-1, num_nodes, N1 + 5], int(bad.sum()))
    t = rng.integers(100, 100 + max(2, E // 16), E).astype(np.int32)
    t[rng.random(E) < 0.02] = -5
    valid = rng.random(E) >= 0.2
    cols = [up(src), up(dst), up(t), up(rng.normal(size=(E, R)).astype(np.float32)), up(valid)]
    fresh = lambda: TGNMemoryState(*(x.clone() for x in state))
    got, again, want = fresh(), fresh(), fresh()
    before = tgn_store_commit.launches
    tgn_store_commit(got, *cols)
    assert tgn_store_commit.launches == before + 1
    tgn_store_commit(again, *cols)
    tgn_store_commit_plain(want, *cols)
    torch.cuda.synchronize()
    for g, a, w, s in zip(got, again, want, state):
        assert torch.equal(g, w) and torch.equal(g, a)
        assert torch.equal(g[N1 - 1], s[N1 - 1])  # the dump row
    assert torch.equal(got.mem, state.mem) and torch.equal(got.last_update, state.last_update)
    if E > 1:  # winners wrote times above the state's
        assert not torch.equal(got.s_t, state.s_t) and not torch.equal(got.d_t, state.d_t)


@pytest.mark.parametrize("k_of", ["3", "B"])
@pytest.mark.parametrize("B", [10, 20, 64])
@pytest.mark.parametrize("D", [172, 7])
def test_fused_select_kernel_matches_plain(card, B, D, k_of):
    """The eid select on the state in place with the feature rows copied,
    at the TGN eval seed count: ring rows in no time order, PAD slots, wp
    past B, invalid seeds on both sides, edge ids past the table (clamped,
    as ``gather_edge_feats`` does). D = 7 takes 4-byte units."""
    rng = np.random.default_rng(B + D)
    S, N, E_all = 4400, 5000, 3000
    k = 3 if k_of == "3" else B
    up = lambda x: torch.as_tensor(x, device=card)
    state = (up(rng.integers(-1, 9, (N + 1, B)).astype(np.int32)),
             up(rng.integers(0, 30, (N + 1, B)).astype(np.int32)),
             up(rng.integers(-1, E_all + 3, (N + 1, B)).astype(np.int32)),
             up(rng.integers(0, 5 * B, N + 1).astype(np.int32)))
    seeds = up(rng.integers(-2, N + 3, S).astype(np.int32))
    qt = up(rng.integers(0, 35, S).astype(np.int32))
    edge_x = up(rng.normal(size=(E_all, D)).astype(np.float32))
    before = recency_eid_select.launches
    got = recency_eid_select(state, seeds, qt, k, edge_x)
    bare = recency_eid_select(state, seeds, qt, k)
    assert recency_eid_select.launches == before + 2
    want = recency_eid_select_plain(state, seeds, qt, k, edge_x)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(bare[:3], want):
        assert torch.equal(g, w)
    assert bare[3].shape == (S, k, 0) and bool((got[2] == -1).any())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", [172, 100, 173, 7])
def test_fused_select_kernel_copies_bf16_rows(card, D, offset):
    """bf16 tables: the kernel copies each row's bytes in the widest unit
    that divides the row's bytes and both base addresses (344- and 200-byte
    rows in 8-byte units, 346 and 14 in 2-byte units; ``offset`` = 1 starts
    the table 2 bytes past an aligned address, so every row takes 2-byte
    units), bit for bit ``gather_edge_feats`` of the same table."""
    rng = np.random.default_rng(D + offset)
    S, N, B, E_all = 4400, 5000, 10, 3000
    up = lambda x: torch.as_tensor(x, device=card)
    state = (up(rng.integers(-1, 9, (N + 1, B)).astype(np.int32)),
             up(rng.integers(0, 30, (N + 1, B)).astype(np.int32)),
             up(rng.integers(-1, E_all + 3, (N + 1, B)).astype(np.int32)),
             up(rng.integers(0, 5 * B, N + 1).astype(np.int32)))
    seeds = up(rng.integers(-2, N + 3, S).astype(np.int32))
    qt = up(rng.integers(0, 35, S).astype(np.int32))
    flat = up(rng.normal(size=E_all * D + offset).astype(np.float32)).to(torch.bfloat16)
    edge_x = flat[offset:].view(E_all, D)
    got = recency_eid_select(state, seeds, qt, B, edge_x)
    want = recency_eid_select_plain(state, seeds, qt, B, edge_x)
    torch.cuda.synchronize()
    assert got[3].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
    assert bool((got[2] == -1).any()) and bool((got[2] >= 0).any())


@pytest.mark.parametrize("S, B, k, D", [(700, 10, 3, 172), (4400, 20, 20, 172), (300, 64, 64, 5),
                                        (90, 40, 33, 7), (16, 10, 10, 172)])
def test_feature_select_kernel_matches_plain(card, S, B, k, D):
    """Random ring rows in no time order (PAD slots, wp past B); D = 5 and 7
    take the scalar copy, D = 172 the float4 one. S = 16, B = K = 10 is the
    node-property path's shape (the padded label count of a batch)."""
    rng = np.random.default_rng(S + B)
    up = lambda x: torch.as_tensor(x, device=card)
    args = (up(rng.integers(-1, 9, (S, B)).astype(np.int32)),
            up(rng.integers(0, 30, (S, B)).astype(np.int32)),
            up(rng.normal(size=(S, B, D)).astype(np.float32)),
            up(rng.integers(0, 5 * B, S).astype(np.int32)),
            up(rng.integers(0, 35, S).astype(np.int32)))
    before = recency_window_select.launches
    got = recency_window_select(*args, k)
    assert recency_window_select.launches == before + 1
    want = recency_window_select_plain(*args, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _feature_state(rng, N, B, D, chronological, dev):
    """A feature-layout state of N + 1 rows, the dump row pristine: as a
    chronological stream's pushes leave it (times non-decreasing in push
    order with ties, PAD slots in rows pushed fewer than B times, empty
    rows, write positions past B), or random rows in no time order."""
    if chronological:
        ids = np.full((N + 1, B), -1, np.int32)
        times = np.zeros((N + 1, B), np.int32)
        count = rng.integers(0, 3 * B, N + 1)
        ev_t = 1000 + np.cumsum(rng.integers(0, 3, (N + 1, 3 * B)), axis=1)
        for e in range(3 * B):
            live = e < count
            ids[live, e % B] = rng.integers(0, N, live.sum())
            times[live, e % B] = ev_t[live, e]
        wp = count.astype(np.int32)
    else:
        ids = rng.integers(-1, 9, (N + 1, B)).astype(np.int32)
        times = rng.integers(0, 30, (N + 1, B)).astype(np.int32)
        wp = rng.integers(0, 5 * B, N + 1).astype(np.int32)
    feats = rng.normal(size=(N + 1, B, D)).astype(np.float32)
    ids[-1], times[-1], feats[-1], wp[-1] = -1, 0, 0.0, 0
    up = lambda x: torch.as_tensor(x, device=dev)
    return up(ids), up(times), up(feats), up(wp)


@pytest.mark.parametrize("chronological", [True, False])
@pytest.mark.parametrize("S, B, k, D", [(4400, 20, 20, 172), (600, 20, 20, 172), (600, 10, 10, 172),
                                        (16, 10, 10, 172), (16, 7, 7, 172), (600, 20, 8, 5),
                                        (600, 20, 20, 0), (90, 64, 64, 172), (300, 40, 33, 8),
                                        (4400, 64, 64, 200), (4400, 32, 32, 128)])
def test_feats_select_kernel_matches_plain(card, S, B, k, D, chronological):
    """K4 on the feature-layout state in place, with invalid seeds (-1, N,
    N + 7), on chronological and random rows: float4 copies where D % 4 ==
    0, D = 5 the scalar copy, D = 0 no copy; the seeds' columns split over
    warps at S = 600 and below, one warp a seed at S = 4,400."""
    rng = np.random.default_rng(S + B + k + D + chronological)
    N = 5000
    state = _feature_state(rng, N, B, D, chronological, card)
    seeds = rng.integers(0, N, S).astype(np.int32)
    seeds[:3] = [-1, N, N + 7]
    seeds = torch.as_tensor(seeds, device=card)
    rows = torch.where((seeds >= 0) & (seeds < N), seeds, N).long()
    qt = (state[1].max(dim=1).values[rows]
          + torch.as_tensor(rng.integers(-4, 3, S), device=card)).int()
    before = recency_feats_select.launches
    got = recency_feats_select(state, seeds, qt, k)
    assert recency_feats_select.launches == before + 1
    want = recency_feats_select_plain(state, seeds, qt, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert bool((got[0][:3] == -1).all()) and bool((got[0][3:] != -1).any())


def _layers(rng, D, F, L, dev):
    n = lambda *s, sc=1.0: torch.as_tensor((rng.normal(size=s) * sc).astype(np.float32), device=dev)
    return [dict(ln1_scale=1 + n(D, sc=0.1), ln1_bias=n(D, sc=0.1), wqkv=n(D, 3 * D, sc=D ** -0.5),
                 bqkv=n(3 * D, sc=0.1), wo=n(D, D, sc=D ** -0.5), bo=n(D, sc=0.1),
                 ln2_scale=1 + n(D, sc=0.1), ln2_bias=n(D, sc=0.1), w1=n(D, F, sc=D ** -0.5),
                 b1=n(F, sc=0.1), w2=n(F, D, sc=F ** -0.5), b2=n(D, sc=0.1)) for _ in range(L)]


# Ragged row tiles (R * S not a multiple of the GEMMs' 128 rows: R = 3 at S
# = 16, R = 5 at S = 48, R = 7 at S = 32, R = 4,201 at S = 64), H = 3, one
# and two layers, the serving shape (R = 4,200 joint sequences of 64), a
# width past the LayerNorm's register path (D = 320) and an odd width (D =
# 35, 5 heads of 7).
@pytest.mark.parametrize("R, S, D, H, F, L", [
    (8, 16, 32, 2, 128, 2), (64, 64, 200, 2, 800, 2), (5, 48, 48, 3, 100, 1),
    (3, 16, 32, 2, 128, 1), (7, 32, 96, 3, 384, 2), (4201, 64, 200, 2, 800, 2),
    (4200, 64, 200, 2, 800, 2), (5, 16, 320, 2, 256, 1), (6, 32, 35, 5, 70, 2),
])
def test_transformer_stack_kernel_matches_plain(card, R, S, D, H, F, L):
    rng = np.random.default_rng(R + D)
    x = torch.as_tensor(rng.normal(size=(R, S, D)).astype(np.float32), device=card)
    sw = stack_weights(_layers(rng, D, F, L, card), H)
    before = transformer_stack_fwd.launches
    got = transformer_stack_fwd(x, sw, H)
    assert transformer_stack_fwd.launches == before + 1
    want = transformer_stack_fwd_plain(x, sw, H)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-3 * float(want.abs().max())
    with pytest.raises(ValueError):
        transformer_stack_fwd(x[:, :S - 8], sw, H)  # rows not a multiple of 16


def test_transformer_stack_kernel_is_deterministic(card):
    """No atomics: each CTA owns its outputs, so two calls agree bit for bit;
    the input is only read (layer 0 reads it in place of a copy). The
    per-stage timing gives a positive time for each of the 2 x 5
    kernels, and the attention kernel fits at least 3 CTAs on an SM."""
    rng = np.random.default_rng(11)
    R, S, D, H, F = 301, 64, 200, 2, 800
    x = torch.as_tensor(rng.normal(size=(R, S, D)).astype(np.float32), device=card)
    x0 = x.clone()
    sw = stack_weights(_layers(rng, D, F, 2, card), H)
    first = transformer_stack_fwd(x, sw, H)
    second = transformer_stack_fwd(x, sw, H)
    ms = transformer_stack_stage_ms(x, sw)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(x, x0)
    assert ms.shape == (2, 5) and bool((ms > 0).all()) and bool(torch.isfinite(ms).all())
    occ = transformer_stack_occupancy(S, D, H, sw.F)
    assert occ["attention"] >= 3 and min(occ.values()) >= 1


# ---------------------------------------------------------------------- #
# TGAT's shapes: K1 over the side-augmented table, the side-payload push,
# the two-hop hook
# ---------------------------------------------------------------------- #
def test_fused_select_over_aug_table_matches_plain(card):
    """K1 over a (2E, 173) side-augmented table (D % 4 != 0: the scalar
    copy), rings holding payloads 2 * eid + side, at TGATPipeline's eval
    shape of its deepest hop (S = 44,000, B = K = 10)."""
    from tgm_tpu_torch.train.tgat_pipeline import build_aug_table

    rng = np.random.default_rng(173)
    N, E, B, S = 900, 5000, 10, 44_000
    up = lambda x: torch.as_tensor(x, device=card)
    aug = build_aug_table(up(rng.normal(size=(E, 172)).astype(np.float32)),
                          up(rng.normal(size=(N, 1)).astype(np.float32)),
                          rng.integers(0, N, E), rng.integers(0, N, E))
    assert aug.shape == (2 * E, 173)
    state = (up(rng.integers(-1, N, (N + 1, B)).astype(np.int32)),
             up(rng.integers(0, 30, (N + 1, B)).astype(np.int32)),
             up(rng.integers(-1, 2 * E, (N + 1, B)).astype(np.int32)),
             up(rng.integers(0, 5 * B, N + 1).astype(np.int32)))
    seeds = up(rng.integers(-1, N + 2, S).astype(np.int32))
    qt = up(rng.integers(0, 35, S).astype(np.int32))
    before = recency_eid_select.launches
    got = recency_eid_select(state, seeds, qt, B, aug)
    assert recency_eid_select.launches == before + 1
    want = recency_eid_select_plain(state, seeds, qt, B, aug)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].shape == (S, B, 173) and bool((got[2] >= 0).any())


def test_side_payload_push_matches_plain_and_the_undirected_plan(card):
    """Both orientations of 200 edges as one directed push of 400 events with
    payloads 2 * eid + 1 and 2 * eid (TGATPipeline's push): kernel equal to
    its plain version, and to the undirected push of the same edges in ids,
    times and write positions, with payload >> 1 the edge id."""
    rng = np.random.default_rng(400)
    N, E, B = 300, 200, 10
    up = lambda x: torch.as_tensor(x, device=card)
    state = recency_eid_init(N, B, card)
    src, dst = (up(rng.integers(0, N, E).astype(np.int32)) for _ in range(2))
    t = up(np.sort(rng.integers(0, 50, E)).astype(np.int32))
    eids = up(np.arange(E, dtype=np.int32))
    valid = up(rng.random(E) > 0.05)
    two = lambda a, b: torch.cat([a, b])
    cols = (two(src, dst), two(dst, src), two(t, t), two(eids * 2 + 1, eids * 2), two(valid, valid))
    got, want, plain_undirected = ([x.clone() for x in state] for _ in range(3))
    before = recency_push.launches
    recency_push(*got, *cols, True)
    assert recency_push.launches == before + 2
    recency_push_plain(*want, *cols, True)
    recency_push_plain(*plain_undirected, src, dst, t, eids, valid, False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for i in (0, 1, 3):
        assert torch.equal(got[i], plain_undirected[i])
    assert torch.equal(torch.where(got[2] >= 0, got[2] >> 1, -1), plain_undirected[2])


@pytest.mark.parametrize("edge_x_full", [True, False])
def test_two_hop_hook_launches_one_select_a_hop(card, edge_x_full):
    """The two-hop recency hook on the card equals it on the CPU, with one
    K1 (eid layout) or K4 (feature layout) launch a hop and one push."""
    from tgm_tpu_torch.core.batch import DGBatch
    from tgm_tpu_torch.hooks import RecencyNeighborHook

    rng = np.random.default_rng(2)
    N, E, D, nb = 50, 64, 172, 6
    table = rng.normal(size=(nb * E, D)).astype(np.float32)
    keys = (["edge_src", "edge_dst"], ["edge_time", "edge_time"])
    kw = dict(edge_x_full=table) if edge_x_full else {}
    runs = {}
    for dev in (card, torch.device("cpu")):
        hook = RecencyNeighborHook(N, [5, 3], *keys, edge_dim=D, device=dev, **kw)
        state = hook.init_state()
        launches = (recency_eid_select.launches, recency_feats_select.launches,
                    recency_push.launches, recency_window_select.launches)
        for b in range(nb):
            r = np.random.default_rng(b)
            sl = slice(b * E, (b + 1) * E)
            up = lambda x: torch.as_tensor(x, device=dev)
            batch = DGBatch(up(r.integers(0, N, E).astype(np.int32)),
                            up(r.integers(0, N, E).astype(np.int32)),
                            up(np.full(E, 10 * b, np.int32)), up(np.ones(E, bool)),
                            edge_ids=up(np.arange(sl.start, sl.stop, dtype=np.int32)),
                            edge_x=up(table[sl]))
            state, batch = hook.apply(state, batch)
        runs[dev.type] = ([x.cpu() for x in state], [x.cpu() for x in batch.nbr_edge_x])
        if dev.type == "cuda":
            got = (recency_eid_select.launches - launches[0],
                   recency_feats_select.launches - launches[1], recency_push.launches - launches[2],
                   recency_window_select.launches - launches[3])
            assert got == ((2 * nb, 0, 2 * nb, 0) if edge_x_full else (0, 2 * nb, 2 * nb, 0)), got
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert torch.equal(g, c)
    for g, c in zip(runs["cuda"][1], runs["cpu"][1]):
        assert torch.equal(g, c)


def test_time2vec_card_equals_cpu_at_large_gaps(card):
    """Time2Vec's phase is rounded once on both devices: at gaps of millions
    of seconds the card's encoding equals the CPU's (ROADMAP.md fault 9)."""
    from tgm_tpu_torch.nn import Time2Vec

    rng = np.random.default_rng(9)
    mod = Time2Vec(100)
    with torch.no_grad():
        mod.w.weight.mul_(torch.as_tensor(1 + 1e-3 * rng.normal(size=(100, 1)), dtype=torch.float32))
        mod.w.bias.copy_(torch.as_tensor(0.01 * rng.normal(size=100), dtype=torch.float32))
    dt = torch.as_tensor(rng.integers(0, 2_700_000, (512, 20)).astype(np.int32))
    want = mod(dt)
    got = mod.to(card)(dt.to(card)).cpu()
    assert float((got - want).abs().max()) <= 1e-6


def test_dedup_hook_on_the_card_equals_the_cpu(card):
    """``DeduplicationHook`` (a sort, a first-of-run mask, a cumsum and a
    scatter: no host sync) gives the CPU's products exactly, at the TGN eval
    shape (48,800 ids capped at N + 1 = 9,228) and the train shape (6,600)."""
    from tgm_tpu_torch.core.batch import DGBatch
    from tgm_tpu_torch.hooks import DeduplicationHook

    rng = np.random.default_rng(21)
    n = 9_227
    for n_neg, K in ((4_000, 10), (200, 10)):
        B = 200
        S = 2 * B + n_neg
        src = rng.integers(0, n, B).astype(np.int32)
        dst = rng.integers(0, n, B).astype(np.int32)
        neg = rng.integers(-1, n, n_neg).astype(np.int32)
        nbrs = rng.integers(-1, n, (S, K)).astype(np.int32)
        out = []
        for dev in (card, torch.device("cpu")):
            up = lambda a: torch.as_tensor(a, device=dev)
            b = DGBatch(up(src), up(dst), up(np.zeros(B, np.int32)), up(np.ones(B, bool)),
                        neg=up(neg), nbr_nids=[up(nbrs)])
            b = DeduplicationHook(n, seed_nodes_keys=["neg", "nbr_nids"])(None, b)
            out.append([b.unique_nids.cpu(), b.num_unique.cpu(), b.global_to_local.cpu()])
        for g, c in zip(*out):
            assert torch.equal(g, c)
        assert out[0][0].shape[0] == min(2 * B + n_neg + S * K, n + 1)


@pytest.mark.parametrize("E, U, H", [(6_000, 6_600, 2), (44_000, 9_228, 2)])
def test_segment_ops_on_the_card_equal_the_cpu(card, E, U, H):
    """Segment softmax and sums at the TGN segment encoder's shapes (train:
    6,000 local edges over 6,600 rows; eval: 44,000 over 9,228): the card's
    ``index_add`` sums in another order, so sums agree within 1e-6 relative
    to the largest magnitude; ``segment_max`` exactly."""
    from tgm_tpu_torch.ops import segment_max, segment_softmax, segment_sum

    rng = np.random.default_rng(E)
    ids = torch.as_tensor(rng.integers(0, U // 3, E), dtype=torch.int32)  # many per segment
    logits = torch.as_tensor(rng.normal(size=(E, H)) * 4, dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(E, H, 50)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(E) < 0.8)
    cpu = [segment_max(logits, ids, U, mask, initial=-1e30),
           segment_softmax(logits, ids, U, mask)]
    cpu.append(segment_sum(cpu[1][..., None] * v, ids, U, mask))
    g_ids, g_logits, g_v, g_mask = (x.to(card) for x in (ids, logits, v, mask))
    gpu = [segment_max(g_logits, g_ids, U, g_mask, initial=-1e30),
           segment_softmax(g_logits, g_ids, U, g_mask)]
    gpu.append(segment_sum(gpu[1][..., None] * g_v, g_ids, U, g_mask))
    assert torch.equal(gpu[0].cpu(), cpu[0])
    for g, c in zip(gpu[1:], cpu[1:]):
        scale = float(c.abs().max())
        assert float((g.cpu() - c).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("kw", [dict(batch_size=200), dict(batch_size=50, batch_unit="s")])
def test_device_event_stream_on_the_card_equals_the_cpu(card, kw):
    """``DeviceEventStream`` batches (edges, edge ids, features and the
    node-label fields) on the card equal the CPU's, bit for bit; then the
    node path's hooks (the recency hook seeded by the label nodes, the
    dedup hook) launch K4 once and the push twice a batch and give the
    CPU's products."""
    from tgm_tpu_torch import DGDataLoader, DGraph
    from tgm_tpu_torch.examples._datasets import load_dataset
    from tgm_tpu_torch.hooks import DeduplicationHook, HookManager, RecencyNeighborHook
    from tgm_tpu_torch.train import DeviceEventStream

    data = load_dataset("synthetic-500-8000", node_label_classes=10)[0]
    dg = DGraph(data.split()[0])
    n = data.num_nodes
    out = {}
    for dev in (card, torch.device("cpu")):
        stream = DeviceEventStream(DGDataLoader(dg, device=dev, **kw))
        hm = HookManager(keys=["all"])
        hm.register_shared(RecencyNeighborHook(n, [10], ["node_y_nids"], ["node_y_time"],
                                               edge_dim=172, device=dev))
        hm.register_shared(DeduplicationHook(n, seed_nodes_keys=["nbr_nids"]))
        fn, states = hm.as_transform("all", dg)
        k4, push = recency_feats_select.launches, recency_push.launches
        pre = recency_window_select.launches
        batches = []
        for i in range(stream.num_batches):
            states, b = fn(states, stream.batch_at(i))
            batches.append({k: (v[0] if isinstance(v, list) else v).cpu()
                            for k, v in b.__dict__.items()
                            if isinstance(v, (list, torch.Tensor))})
        if dev.type == "cuda":
            assert recency_feats_select.launches - k4 == stream.num_batches
            assert recency_window_select.launches == pre  # the pre-gathered entry: never
            assert recency_push.launches - push == 2 * stream.num_batches
        out[dev.type] = batches
    assert len(out["cuda"]) == len(out["cpu"]) > 10
    for i, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        assert g.keys() == c.keys()
        for name in g:
            assert torch.equal(g[name], c[name]), (i, name)
