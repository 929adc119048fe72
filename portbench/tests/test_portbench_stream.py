"""The stream generator and the candidate tables."""

import json

import numpy as np
import pytest

from portbench.yard import candidates, stream as gen
from tiny import HERE

TRAFFIC = json.loads((HERE / "traffic" / "tgb-q999.json").read_text())


@pytest.fixture(scope="module")
def wiki():
    return gen.generate(TRAFFIC["stream"], 2**33 + 1)


def test_wiki_shape(wiki):
    p = TRAFFIC["stream"]
    assert wiki.src.shape == wiki.dst.shape == (157_474,)
    assert wiki.edge_x.shape == (157_474, 172) and wiki.edge_x.dtype == np.float32
    assert wiki.num_nodes == 9_227
    # Bipartite: users are sources, pages destinations.
    assert wiki.src.min() >= 0 and wiki.src.max() < p["users"]
    assert wiki.dst.min() >= p["users"] and wiki.dst.max() < p["users"] + p["items"]
    assert np.all(np.diff(wiki.t) > 0) and wiki.t[0] >= 0 and wiki.t[-1] <= p["time_span_s"]
    sizes = {k: b - a for k, (a, b) in wiki.bounds.items()}
    assert sizes == {"train": 110_232, "val": 23_621, "test": 23_621}


def test_wiki_activity(wiki):
    for split in ("val", "test"):
        assert 0.85 <= gen.repeat_share(wiki, split) <= 0.93
    for split in ("train", "val", "test"):
        assert len(np.unique(wiki.src[wiki.split(split)])) > 2_000
    counts = np.sort(np.bincount(wiki.dst - 8_227, minlength=1_000))[::-1]
    assert counts[:10].sum() > 10 * counts[500:510].sum()  # heavy-tailed


def test_deterministic_per_seed():
    small = dict(TRAFFIC["stream"], users=50, items=20, edges=2_000, edge_dim=3)
    a, b, c = gen.generate(small, 7), gen.generate(small, 7), gen.generate(small, 8)
    for f in ("src", "dst", "t", "edge_x"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.dst, c.dst)


@pytest.mark.parametrize("kind", ["all_other_items", "historical_random"])
def test_candidates(wiki, kind):
    spec = {"kind": kind, "historical": 10, "random": 10}
    cands = candidates.generate({"candidates": spec}, wiki, 5)
    again = candidates.generate({"candidates": spec}, wiki, 5)
    Q = 999 if kind == "all_other_items" else 20
    for split in ("val", "test"):
        c, dst = cands[split], wiki.dst[wiki.split(split)]
        assert c.shape == (23_621, Q) and np.array_equal(c, again[split])
        assert not (c == dst[:, None]).any()
        assert c.min() >= 8_227 and c.max() < 9_227
        srt = np.sort(c, axis=1)
        assert not (srt[:, 1:] == srt[:, :-1]).any()  # distinct in a row
    if kind == "historical_random":
        # The first candidates of an edge are pages its user linked to before.
        a = wiki.bounds["val"][0]
        seen = set(zip(wiki.src[:a].tolist(), wiki.dst[:a].tolist()))
        src = wiki.src[wiki.split("val")]
        hits = np.mean([(int(s), int(c)) in seen for s, c in zip(src[:500], cands["val"][:500, 0])])
        assert hits > 0.8
