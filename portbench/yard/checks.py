"""The numbers that decide ``correct``: what the timed path produced
against what the plain reference works out, each beside its limit."""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import torch

PAD = -1


def ring_canonical(ids: torch.Tensor, times: torch.Tensor, payload: torch.Tensor,
                   write_pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A recency ring state (N, B) read in age order: each node's entries
    oldest to newest, right-aligned (slot j's age is (wp - 1 - j) mod B)."""
    N, B = ids.shape
    slot = torch.arange(B)
    age = torch.remainder(write_pos.long()[:, None] - 1 - slot[None, :], B)
    order = torch.argsort(-age, dim=1)  # oldest first
    g = lambda x: torch.gather(x, 1, order if x.dim() == 2 else
                               order[:, :, None].expand(-1, -1, x.shape[2]))
    return {"ring_ids": g(ids), "ring_times": g(times), "ring_payload": g(payload)}


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ (a shape mismatch counts every element)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    return int((a.cpu() != b.cpu()).sum())


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (the reference is ``b``) over the elements
    where ``b`` is not NaN (a reference marks rows it has no answer for so)."""
    a, b = a.double().cpu(), b.double().cpu()
    if a.shape != b.shape:
        return float("inf")
    known = ~torch.isnan(b)
    if not bool(known.any()):
        return float("nan")
    a, b = a[known], b[known]
    scale = b.abs().max().clamp_min(1e-30)
    return float(((a - b).abs().max() / scale))


def rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """rms(a - b) / rms(b) (the reference is ``b``) over the elements where
    ``b`` is not NaN: a steadier reading than ``rel_gap``'s maximum."""
    a, b = a.double().cpu(), b.double().cpu()
    if a.shape != b.shape:
        return float("inf")
    known = ~torch.isnan(b)
    if not bool(known.any()):
        return float("nan")
    a, b = a[known], b[known]
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30))


def kept_score_gap(got: Mapping, ref: Mapping, gap=rel_gap) -> float:
    """The widest ``gap`` of a kept batch's scores from the reference's."""
    gaps = [gap(sc[:ref["scores"][k].shape[0]], ref["scores"][k])
            for k, sc in got["scores"].items()]
    return max(gaps) if gaps else float("nan")


def exact_total(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> int:
    return sum(mismatches(a, b) for a, b in pairs)


def mrr_interval(scores: torch.Tensor, band: float) -> Tuple[float, float]:
    """The least and the most MRR sum (TGB's tie rule) of a batch's (n, Q + 1)
    reference scores, the positive first, that scores each within
    ``band / 2 * max |score|`` of them can give: a rank decision between
    scores closer than ``band * max |score|`` may fall either way."""
    s = scores.double()
    pos, neg = s[:, :1], s[:, 1:]
    eps = band * float(s.abs().max())
    rr = lambda gt, ge: (1.0 / (0.5 * (gt.sum(1) + ge.sum(1)).double() + 1.0)).sum()
    worst = rr(neg > pos - eps, neg >= pos - eps)
    best = rr(neg > pos + eps, neg >= pos + eps)
    return float(worst), float(best)


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict]:
    """``correct`` and ``{name: {"value", "limit"}}``; a number missing from
    ``numbers`` or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        good = v == v and v <= limit
        ok &= bool(good)
        out[name] = {"value": v, "limit": limit}
    return ok, out


# How far a float32 sum of a batch's reciprocal ranks can round.
SUM_SLACK = 1e-4


def linkpred_numbers(got: Mapping, ref: Mapping, tie_tol: float,
                     float_state: Iterable[str] = ()) -> Dict[str, float]:
    """The numbers every link-prediction eval cell compares: the kept hook
    products and the state (but ``float_state``) exactly, the MRR counts of
    every batch exactly, and the scored batches whose MRR sum lies outside
    the reference's interval (``mrr_interval``, each score free to move by
    ``tie_tol`` of the batch's largest) by more than float32 sums can
    round. ``got``: what the program produced (``evalcell.run``)."""
    float_state = tuple(float_state)
    n = {}
    products = got["products"]
    n["hook_mismatch"] = float(sum(
        mismatches(products[k][name], ref["products"][k][name])
        for k in products for name in products[k]))
    exact = [(got["state"][k], ref["state"][k]) for k in ref["state"] if k not in float_state]
    n["state_mismatch"] = float(exact_total(exact))
    pairs = list(zip(got["batch_log"], got["outs"]))
    n["count_mismatch"] = float(sum(abs(float(o[1]) - ref["counts"][(sp, i)])
                                    for (sp, i, *_), o in pairs))
    intervals = {k: mrr_interval(sc, 2.0 * tie_tol) for k, sc in ref["scores"].items()}
    served = [(float(o[0]), intervals[(sp, i)]) for (sp, i, *_), o in pairs
              if (sp, i) in intervals]
    n["mrr_outside_band"] = (float(sum(not lo - SUM_SLACK <= v <= hi + SUM_SLACK
                                       for v, (lo, hi) in served))
                             if served else float("nan"))
    return n
