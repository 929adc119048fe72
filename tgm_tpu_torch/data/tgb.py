"""Loaders for the TGB and TGB-Seq benchmark packages (port of
``tgm_tpu/data/tgb.py``), behind ``DGData.from_tgb`` and
``DGData.from_tgb_seq``.

Every family keeps its handling: tgbl- edges and features; tgbn- node-label
dicts flattened into label events (labels outside ``[t_0 - 1, t_last)``
dropped); tkgl- edge features doubled for the inverse relations, and edge
types; thgl- edge and node types. The official split is kept as a
``TGBSplit`` of each mask's time bounds. The ``tgb`` and ``tgb_seq``
packages are optional and imported only here, when a loader runs.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np

from ..timedelta import TGB_SEQ_TIME_DELTAS, TGB_TIME_DELTAS, TimeDeltaDG
from ..util.logging import _get_logger
from .split import TGBSplit

logger = _get_logger(__name__)


def _split_bounds(times: np.ndarray, masks) -> dict:
    return {name: (int(times[np.asarray(m, dtype=bool)].min()),
                   int(times[np.asarray(m, dtype=bool)].max()))
            for name, m in zip(("train", "val", "test"), masks)}


def load_tgb(cls, name: str, time_delta: Union[TimeDeltaDG, str, None] = None, **kwargs: Any):
    try:
        from tgb.linkproppred.dataset import LinkPropPredDataset
        from tgb.nodeproppred.dataset import NodePropPredDataset
    except ImportError as e:
        raise ImportError("TGB required to load TGB data, try `pip install py-tgb`") from e

    if name.startswith(("tgbl-", "tkgl-", "thgl-")):
        dataset = LinkPropPredDataset(name=name, **kwargs)
    elif name.startswith("tgbn-"):
        dataset = NodePropPredDataset(name=name, **kwargs)
    else:
        raise ValueError(f"Unknown TGB dataset: {name}")

    data = dataset.full_data
    edge_index = np.stack(
        [data["sources"].astype(np.int64), data["destinations"].astype(np.int64)], axis=1)
    timestamps = data["timestamps"].astype(np.int64)

    edge_x = None
    if data.get("edge_feat") is not None:
        edge_x = data["edge_feat"].astype(np.float32)
        if name.startswith("tkgl-"):
            # Each relation's features serve its inverse relation too.
            edge_x = np.concatenate([edge_x, edge_x], axis=0)

    node_y_time = node_y_nids = node_y = None
    if name.startswith("tgbn-"):
        node_label_dict = data.get("node_label_dict")
        if node_label_dict is None:
            raise ValueError("TGB dataset missing node_label_dict; upgrade py-tgb")
        lo, hi = int(timestamps[0]) - 1, int(timestamps[-1])
        items = [(t, d) for t, d in node_label_dict.items() if lo <= t < hi]
        if items:
            ts, nids, labels = [], [], []
            for t, per_node in items:
                for node_id, label in per_node.items():
                    ts.append(t)
                    nids.append(node_id)
                    labels.append(np.asarray(label, dtype=np.float32))
            node_y_time = np.asarray(ts, dtype=np.int64)
            node_y_nids = np.asarray(nids, dtype=np.int64)
            node_y = np.stack(labels).astype(np.float32)

    static_node_x = None
    if getattr(dataset, "node_feat", None) is not None:
        static_node_x = np.asarray(dataset.node_feat, dtype=np.float32)

    edge_type = node_type = None
    if name.startswith("thgl"):
        edge_type = data["edge_type"].astype(np.int64)
        node_type = np.asarray(dataset.node_type, dtype=np.int64)
    elif name.startswith("tkgl"):
        edge_type = data["edge_type"].astype(np.int64)

    out = cls.from_raw(
        time_delta=time_delta or TGB_TIME_DELTAS[name],
        edge_time=timestamps,
        edge_index=edge_index,
        edge_x=edge_x,
        node_y_time=node_y_time,
        node_y_nids=node_y_nids,
        node_y=node_y,
        static_node_x=static_node_x,
        edge_type=edge_type,
        node_type=node_type,
    )
    out._split_strategy = TGBSplit(_split_bounds(
        timestamps, (dataset.train_mask, dataset.val_mask, dataset.test_mask)))
    logger.info("Loaded %s: %d edges", name, out.num_edge_events)
    return out


def load_tgb_seq(cls, name: str, time_delta: Union[TimeDeltaDG, str, None] = None,
                 **kwargs: Any):
    try:
        from tgb_seq.LinkPred.dataloader import TGBSeqLoader
    except ImportError as e:
        raise ImportError("TGB-Seq required, try `pip install tgb-seq`") from e

    kwargs.setdefault("root", "./data")
    data = TGBSeqLoader(name=name, **kwargs)

    edge_index = np.stack(
        [data.src_node_ids.astype(np.int64), data.dst_node_ids.astype(np.int64)], axis=1)
    timestamps = data.node_interact_times.astype(np.int64)
    edge_x = None if data.edge_features is None else data.edge_features.astype(np.float32)
    static_node_x = None if data.node_features is None else data.node_features.astype(np.float32)

    out = cls.from_raw(
        time_delta=time_delta or TGB_SEQ_TIME_DELTAS[name],
        edge_time=timestamps,
        edge_index=edge_index,
        edge_x=edge_x,
        static_node_x=static_node_x,
    )
    out._split_strategy = TGBSplit(_split_bounds(
        data.node_interact_times, (data.train_mask, data.val_mask, data.test_mask)))
    logger.info("Loaded %s: %d edges", name, out.num_edge_events)
    return out


__all__ = ["load_tgb", "load_tgb_seq"]
