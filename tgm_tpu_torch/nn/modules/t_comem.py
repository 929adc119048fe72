"""t-CoMem, the popularity and co-occurrence memory baseline (port of
``tgm_tpu/nn/modules/t_comem.py``).

State on the device, as the JAX package keeps it on the host:

* per-source rings of the k most recent destinations and times: ``(N, k)``
  int64 ``recent_dst`` and fp64 ``recent_ts``, with ``recent_len`` and the
  write cursor ``recent_pos``. An update sorts its batch by source
  (stably), keeps each source's last k events and scatters them at the
  cursor's advancing slots; every event advances the cursor;
* fp64 destination ``popularity`` (1.0 added per edge, no decay);
* the co-occurrence counts, a ``SortedPairTable`` of (src, dst) keys with
  int64 counts. Each edge counts in both directions; a self-loop counts 2.

A query scores ``base(src) + w * c / (1 + c)``: ``base`` sums, over the
source's ring entries inside the window, ``exp(-(end - t) / size)`` times
``1 / (1 + exp(-popularity[dst]))``, and ``c`` is the queried pair's count
(0 for a pair never seen or with a negative id). The query source is
clamped to ``[0, N - 1]``, as the JAX package clips it. Everything is
fp64 until the float32 result. ``base`` is summed in numpy's order
(``pairwise_row_sum``), so one source's sum is the same bits in every row,
every call and on every device, and equals numpy's where the ``exp``
values do. The window bounds are fp64.

Rows with a negative src or dst are padding and skipped by ``update``.
"""

from __future__ import annotations

import torch

from ...device import DeviceLike, resolve_device
from .edgebank import INT64_MIN, as_long, check_edges, time_range, valid_edges
from .pair_table import SortedPairTable, capacity_for, pair_keys


def pairwise_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of the 2-D ``x`` in the order numpy's ``sum(axis=1)``
    takes over a contiguous row (its pairwise summation: below 8 columns
    one by one; up to 128, eight running sums combined as a tree, then the
    remainder; beyond, the two halves split at a multiple of 8), by
    elementwise adds."""
    n = x.shape[1]
    if n < 8:
        res = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[:, i]
        return res
    if n <= 128:
        m = n - n % 8
        r = x[:, :8]
        for i in range(8, m, 8):
            r = r + x[:, i : i + 8]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(m, n):
            res = res + x[:, i]
        return res
    h = n // 2
    h -= h % 8
    return pairwise_row_sum(x[:, :h]) + pairwise_row_sum(x[:, h:])


class tCoMemPredictor:
    def __init__(
        self,
        src,
        dst,
        ts,
        num_nodes: int,
        k: int = 50,
        window_ratio: float = 0.15,
        co_occurrence_weight: float = 0.8,
        device: DeviceLike = None,
    ) -> None:
        if not 0 < window_ratio <= 1.0:
            raise ValueError("Window ratio must be in (0, 1]")
        if not 0 < co_occurrence_weight <= 1.0:
            raise ValueError("Co-occurrence weight must be in (0, 1]")
        if k <= 0:
            raise ValueError("K must be positive")
        if num_nodes <= 0:
            raise ValueError("num_nodes must be positive")
        if k > num_nodes:
            raise ValueError("k must be smaller than num_nodes")
        self.device = dev = resolve_device(device)
        src, dst, ts = (as_long(x, dev) for x in (src, dst, ts))
        check_edges(src, dst, ts)

        self._window_ratio = window_ratio
        t_min, t_max = (float(t) for t in time_range(ts, valid_edges(src, dst)))
        self._window_size = max(t_max - t_min, 1.0)
        self._window_start = torch.tensor(t_min, dtype=torch.float64, device=dev)
        self._window_end = torch.tensor(t_max, dtype=torch.float64, device=dev)

        self.num_nodes = num_nodes
        self.k = k
        # One slot past the rings takes the writes of the events not kept.
        self._ts_buf = torch.full((num_nodes * k + 1,), -torch.inf, dtype=torch.float64,
                                  device=dev)
        self._dst_buf = torch.full((num_nodes * k + 1,), -1, dtype=torch.int64, device=dev)
        self.recent_ts = self._ts_buf[:-1].view(num_nodes, k)
        self.recent_dst = self._dst_buf[:-1].view(num_nodes, k)
        self.recent_len = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
        self.recent_pos = torch.zeros(num_nodes, dtype=torch.int64, device=dev)

        self.co_occurrence = SortedPairTable(dev, capacity_for(2 * len(src)))
        self.popularity = torch.zeros(num_nodes, dtype=torch.float64, device=dev)
        self.co_occurrence_weight = co_occurrence_weight

        self.update(src, dst, ts)

    def update(self, src, dst, ts) -> None:
        src, dst, ts = (as_long(x, self.device) for x in (src, dst, ts))
        check_edges(src, dst, ts)
        N, k, dev = self.num_nodes, self.k, self.device
        valid = valid_edges(src, dst)
        t_hi = torch.where(valid, ts, INT64_MIN).max().double()
        self._window_end = torch.maximum(self._window_end, t_hi)
        self._window_start = self._window_end - self._window_size

        # Ring writes: padding sorts last (as source N); each source keeps its
        # last k events, the j-th of its batch at slot (pos + j) % k.
        s, order = torch.sort(torch.where(valid, src, N), stable=True)
        M = s.numel()
        ar = torch.arange(M, device=dev)
        start = torch.ones(M, dtype=torch.bool, device=dev)
        start[1:] = s[1:] != s[:-1]
        j = ar - torch.cummax(torch.where(start, ar, 0), 0).values
        counts = torch.zeros(N + 1, dtype=torch.int64, device=dev).index_add_(
            0, s, torch.ones_like(s))
        keep = (j >= counts[s] - k) & (s < N)
        row = torch.where(keep, s, 0)
        slot = torch.where(keep, row * k + (self.recent_pos[row] + j) % k, N * k)
        self._ts_buf.scatter_(0, slot, ts[order].double())
        self._dst_buf.scatter_(0, slot, dst[order])
        c = counts[:N]
        self.recent_pos.add_(c).remainder_(k)
        self.recent_len.add_(c).clamp_(max=k)

        self.co_occurrence.merge(torch.cat([pair_keys(src, dst), pair_keys(dst, src)]),
                                 torch.ones(2 * M, dtype=torch.int64, device=dev), "sum")
        self.popularity.index_add_(0, torch.where(valid, dst, 0), valid.double())

    def __call__(self, query_src, query_dst) -> torch.Tensor:
        qs, qd = as_long(query_src, self.device), as_long(query_dst, self.device)
        rows = qs.clamp(0, self.num_nodes - 1)
        ts_mat = self.recent_ts[rows]
        valid = (torch.arange(self.k, device=self.device)[None, :]
                 < self.recent_len[rows][:, None])
        mask = valid & (ts_mat >= self._window_start) & (ts_mat <= self._window_end)
        ts_valid = torch.where(mask, ts_mat, -torch.inf)
        nbr_valid = torch.where(mask, self.recent_dst[rows], 0)
        decay = torch.exp(-(self._window_end - ts_valid) / self._window_size)
        pop = 1.0 / (1.0 + torch.exp(-self.popularity[nbr_valid]))
        base = pairwise_row_sum(torch.where(mask, decay * pop, 0.0))

        hit, row = self.co_occurrence.lookup(pair_keys(qs, qd))
        cnt = torch.where(hit, self.co_occurrence.values(row), 0).double()
        co = self.co_occurrence_weight * (cnt / (1 + cnt))
        return (base + co).float()

    @property
    def window_start(self) -> float:
        return float(self._window_start)

    @property
    def window_end(self) -> float:
        return float(self._window_end)

    @property
    def window_ratio(self) -> float:
        return self._window_ratio

    @property
    def window_size(self) -> int:
        return int(self._window_end - self._window_start)


__all__ = ["pairwise_row_sum", "tCoMemPredictor"]
