"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels) and
carry the ``cuda`` marker; without a card they skip. On the card:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (the
repo's conftest imports JAX, which the machine with the card need not have).
Tolerances: exact equality for K1-K4 (integer select and scatter, fp32
feature copy); K5 within 5e-3 * max |plain| (bf16 operands rounded at the
same places, fp32 sums in another order: a bf16 rounding that flips moves
its sequence by up to a few 1e-3).
"""

import numpy as np
import pytest
import torch

from tgm_tpu_torch.hooks.neighbors import recency_eid_init, recency_eid_update
from tgm_tpu_torch.ops import (
    recency_window_select,
    recency_window_select_eid,
    recency_window_select_eid_plain,
    recency_window_select_plain,
    scatter_cells,
    scatter_cells_plain,
    tgn_store_scatter_1d,
    tgn_store_scatter_1d_plain,
    stack_weights,
    transformer_stack_fwd,
    transformer_stack_fwd_plain,
)

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


@pytest.mark.parametrize("S, B, k, D", [(700, 10, 3, 172), (4400, 20, 20, 172), (300, 64, 64, 5),
                                        (90, 40, 33, 7)])
def test_feature_select_kernel_matches_plain(card, S, B, k, D):
    """Random ring rows in no time order (PAD slots, wp past B); D = 5 and 7
    take the scalar copy, D = 172 the float4 one."""
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


def _layers(rng, D, F, L, dev):
    n = lambda *s, sc=1.0: torch.as_tensor((rng.normal(size=s) * sc).astype(np.float32), device=dev)
    return [dict(ln1_scale=1 + n(D, sc=0.1), ln1_bias=n(D, sc=0.1), wqkv=n(D, 3 * D, sc=D ** -0.5),
                 bqkv=n(3 * D, sc=0.1), wo=n(D, D, sc=D ** -0.5), bo=n(D, sc=0.1),
                 ln2_scale=1 + n(D, sc=0.1), ln2_bias=n(D, sc=0.1), w1=n(D, F, sc=D ** -0.5),
                 b1=n(F, sc=0.1), w2=n(F, D, sc=F ** -0.5), b2=n(D, sc=0.1)) for _ in range(L)]


@pytest.mark.parametrize("R, S, D, H, F, L", [(8, 16, 32, 2, 128, 2), (64, 64, 200, 2, 800, 2),
                                              (5, 48, 48, 3, 100, 1)])
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
