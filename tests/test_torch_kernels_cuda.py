"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels) and
carry the ``cuda`` marker; without a card they skip. On the card:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (the
repo's conftest imports JAX, which the machine with the card need not have).
Tolerance: exact equality (integer kernels).
"""

import numpy as np
import pytest
import torch

from tgm_tpu_torch.hooks.neighbors import recency_eid_init, recency_eid_update
from tgm_tpu_torch.ops import (
    recency_window_select_eid,
    recency_window_select_eid_plain,
    scatter_cells,
    scatter_cells_plain,
    tgn_store_scatter_1d,
    tgn_store_scatter_1d_plain,
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
