"""The port's segment ops against ``tgm_tpu.ops.segment`` on the CPU.

``segment_sum``, ``segment_max``, ``segment_mean``, ``segment_softmax`` and
``coo_spmm`` on the same numpy inputs (made from a seed): with and without a
mask, with empty segments, tied values and ids outside [0, num_segments).
Forward within 1e-6 (``segment_max`` exact; with trailing axes and a mask
against JAX's column by column, which broadcasts a mask over 1-D data
only), and the gradient of a weighted
sum of the output (``jax.grad`` against autograd) within 1e-6. Sizes: 300
entries over 17 segments, trailing widths 1-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.ops import segment as jseg
from tgm_tpu_torch.ops import coo_spmm, segment_max, segment_mean, segment_softmax, segment_sum

E, NSEG = 300, 17
ATOL = 1e-6


def inputs(seed, trail=(), masked=True, out_of_range=False):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(E,) + trail).astype(np.float32)
    data[::7] = 0.5  # ties inside segments
    ids = rng.integers(0, NSEG - 4, E).astype(np.int32)  # the last 4 segments stay empty
    if out_of_range:
        ids[:9] = [-1, -3, NSEG, NSEG + 1, 40, -1, NSEG, 0, 5]
    mask = (rng.random(E) < 0.8) if masked else None
    weights = rng.normal(size=(NSEG,) + trail).astype(np.float32)
    return data, ids, mask, weights



@pytest.mark.parametrize("name", ["sum", "mean", "max"])
@pytest.mark.parametrize("trail", [(), (3,)])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_segment_reductions_match_jax(name, trail, masked, out_of_range):
    data, ids, mask, w = inputs(1, trail, masked, out_of_range)
    jf = {"sum": jseg.segment_sum, "mean": jseg.segment_mean, "max": jseg.segment_max}[name]
    if name == "max" and trail and masked:
        # The JAX segment_max broadcasts a mask over 1-D data only: take it
        # column by column (the port's mask broadcasts over trailing axes).
        j1 = jf
        jf = lambda d, i, n, m, **k: jnp.stack([j1(d[:, c], i, n, m, **k)
                                                for c in range(d.shape[1])], axis=1)
    tf = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}[name]
    kw = {"initial": -5.0} if name == "max" else {}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jf(jnp.asarray(data), jnp.asarray(ids), NSEG, jm, **kw)
    got = tf(torch.from_numpy(data), torch.from_numpy(ids), NSEG, tm, **kw)
    atol = 0.0 if name == "max" else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    assert (got.numpy()[NSEG - 4:] == (-5.0 if name == "max" else 0.0)).all()  # empty segments

    gw = jax.grad(lambda d: jnp.sum(jf(d, jnp.asarray(ids), NSEG, jm, **kw) * w))(
        jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    (tf(d, torch.from_numpy(ids), NSEG, tm, **kw) * torch.from_numpy(w)).sum().backward()
    if name == "max":
        # Ties share the gradient in torch and go to one entry in JAX; the
        # per-segment totals agree.
        got_g = segment_sum(d.grad, torch.from_numpy(ids), NSEG).numpy()
        want_g = np.asarray(jseg.segment_sum(gw, jnp.asarray(ids), NSEG))
    else:
        got_g, want_g = d.grad.numpy(), np.asarray(gw)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=ATOL)


# Out-of-range ids come masked: an unmasked one reads an empty segment's
# max (-1e30), and its weight overflows in both packages.
@pytest.mark.parametrize("masked, out_of_range", [(False, False), (True, False), (True, True)])
def test_segment_softmax_matches_jax(masked, out_of_range):
    data, ids, mask, _ = inputs(2, (), masked, out_of_range)
    data = data * 30.0  # large logits: the shift matters
    if mask is not None:
        mask[:9] &= not out_of_range
        data[~mask] = 1e4  # masked logits that would overflow the exp
    w = np.random.default_rng(3).normal(size=E).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jf = lambda x: jseg.segment_softmax(x, jnp.asarray(ids), NSEG, jm)
    want = jf(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    got = segment_softmax(d, torch.from_numpy(ids), NSEG, tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if mask is not None:
        assert (got.detach().numpy()[~mask] == 0).all()
    gw = jax.grad(lambda x: jnp.sum(jf(x) * w))(jnp.asarray(data))
    (got * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(d.grad).all()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gw), rtol=0, atol=1e-5)


def test_segment_softmax_broadcasts_the_mask_over_heads():
    """The port takes (E, H) logits in one call; each head equals the 1-D op."""
    data, ids, mask, _ = inputs(4, (2,))
    got = segment_softmax(torch.from_numpy(data), torch.from_numpy(ids), NSEG,
                          torch.from_numpy(mask))
    for h in range(2):
        want = jseg.segment_softmax(jnp.asarray(data[:, h]), jnp.asarray(ids), NSEG,
                                    jnp.asarray(mask))
        np.testing.assert_allclose(got[:, h].numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_coo_spmm_matches_jax(weighted, masked):
    rng = np.random.default_rng(5)
    n = 23
    src = rng.integers(-3, n + 3, E).astype(np.int32)  # clipped into [0, n)
    dst = rng.integers(-3, n + 3, E).astype(np.int32)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.normal(size=E).astype(np.float32) if weighted else None
    mask = (rng.random(E) < 0.7) if masked else None
    cw = rng.normal(size=(n, 4)).astype(np.float32)
    jw = None if w is None else jnp.asarray(w)
    jm = None if mask is None else jnp.asarray(mask)
    jf = lambda xx: jseg.coo_spmm(jnp.asarray(src), jnp.asarray(dst), jw, xx, n, jm)
    want = jf(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = coo_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                   None if w is None else torch.from_numpy(w), xt, n,
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    gw = jax.grad(lambda xx: jnp.sum(jf(xx) * cw))(jnp.asarray(x))
    (got * torch.from_numpy(cw)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gw), rtol=0, atol=ATOL)


def test_integer_segment_max_stays_integer():
    ids = torch.tensor([0, 0, 2, 5, 1], dtype=torch.int32)
    data = torch.tensor([3, 9, -4, 7, 1], dtype=torch.int32)
    out = segment_max(data, ids, 4, mask=torch.tensor([True, True, True, True, False]),
                      initial=-1)
    assert out.dtype == torch.int32
    assert out.tolist() == [9, -1, -1, -1]  # id 5 is out of range; the masked 1 is dropped
