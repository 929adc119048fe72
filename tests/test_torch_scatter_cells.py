"""K2 and K3 plain versions against the Pallas kernels (interpret) and XLA's ``.at[].set``.

Targets include the dump row and out-of-range rows, which must be skipped
and leave the dump row as it was. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.ops.pallas.scatter_cells import scatter_cells as j_scatter_cells
from tgm_tpu.ops.pallas.scatter_cells import tgn_store_scatter_1d as j_store
from tgm_tpu_torch.ops import scatter_cells, tgn_store_scatter_1d


def cells_case(seed, N1=17, B=5, E=30):
    rng = np.random.default_rng(seed)
    buf = rng.integers(-1, 100, (N1, B)).astype(np.int32)
    # Unique live targets, then some aimed at the dump row.
    flat = rng.choice((N1 - 1) * B, E, replace=False)
    rows, cols = (flat // B).astype(np.int32), (flat % B).astype(np.int32)
    dump = rng.random(E) < 0.3
    rows[dump] = N1 - 1
    vals = rng.integers(0, 1000, E).astype(np.int32)
    return buf, rows, cols, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_cells_plain_matches_pallas_and_xla(seed):
    buf, rows, cols, vals = cells_case(seed)
    got = scatter_cells(torch.from_numpy(buf.copy()), *map(torch.from_numpy, (rows, cols, vals)))

    kern = j_scatter_cells(jnp.asarray(buf), jnp.asarray(rows), jnp.asarray(cols),
                           jnp.asarray(vals), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))

    # XLA scatter plus the push's dump-row reset (to the row's old contents).
    xla = jnp.asarray(buf).at[rows, cols].set(vals, mode="drop").at[-1].set(buf[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy()[-1], buf[-1])


def test_scatter_cells_in_place_and_checks():
    buf, rows, cols, vals = cells_case(2)
    t = torch.from_numpy(buf.copy())
    out = scatter_cells(t, *map(torch.from_numpy, (rows, cols, vals)))
    assert out is t and not np.array_equal(t.numpy(), buf)
    with pytest.raises(TypeError):
        scatter_cells(t.long(), *map(torch.from_numpy, (rows, cols, vals)))
    with pytest.raises(ValueError):
        scatter_cells(t, *map(torch.from_numpy, (rows[:-1], cols, vals)))


def store_case(seed, N1=256, E=40):
    rng = np.random.default_rng(seed)
    stores = [rng.integers(-1, 500, N1).astype(np.int32) for _ in range(4)]

    def role():
        rows = rng.choice(N1 - 1, E, replace=False).astype(np.int32)
        rows[rng.random(E) < 0.3] = N1 - 1  # non-winners aim at the dump row
        return rows, rng.integers(0, 500, E).astype(np.int32), rng.integers(0, 9000, E).astype(np.int32)

    return stores, role(), role()


@pytest.mark.parametrize("seed", [0, 1])
def test_store_scatter_plain_matches_pallas_and_xla(seed):
    stores, (rs, vso, vst), (rd, vdo, vdt) = store_case(seed)
    N1 = stores[0].shape[0]
    ups = [rs, vso, vst, rd, vdo, vdt]
    got = tgn_store_scatter_1d(*(torch.from_numpy(s.copy()) for s in stores),
                               *map(torch.from_numpy, ups), last_live_row=N1 - 2)
    kern = j_store(*map(jnp.asarray, stores), *map(jnp.asarray, ups),
                   last_live_row=N1 - 2, interpret=True)
    for g, k in zip(got, kern):
        np.testing.assert_array_equal(g.numpy(), np.asarray(k))

    so, st, do, dt = (jnp.asarray(s) for s in stores)
    xla = (so.at[rs].set(vso).at[-1].set(stores[0][-1]), st.at[rs].set(vst).at[-1].set(stores[1][-1]),
           do.at[rd].set(vdo).at[-1].set(stores[2][-1]), dt.at[rd].set(vdt).at[-1].set(stores[3][-1]))
    for g, x in zip(got, xla):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_store_scatter_skips_past_last_live_row():
    stores, (rs, vso, vst), (rd, vdo, vdt) = store_case(3, N1=64, E=20)
    last_live = 40
    got = tgn_store_scatter_1d(*(torch.from_numpy(s.copy()) for s in stores),
                               *map(torch.from_numpy, (rs, vso, vst, rd, vdo, vdt)),
                               last_live_row=last_live)
    for g, s in zip(got, stores):
        np.testing.assert_array_equal(g.numpy()[last_live + 1:], s[last_live + 1:])
    live = rs <= last_live
    np.testing.assert_array_equal(got[0].numpy()[rs[live]], vso[live])
    with pytest.raises(ValueError):
        tgn_store_scatter_1d(*(torch.from_numpy(s.copy()) for s in stores),
                             *map(torch.from_numpy, (rs, vso, vst, rd, vdo, vdt)),
                             last_live_row=63)
