from .base import BaseDGHook, DGHook, SeedableHook, StatefulHook, StatelessHook
from .registry import hook, list_hooks
from .manager import CORE_ATTRIBUTE, HookManager
# Imported in the JAX package's order: the registry lists the hooks as
# they are defined.
from .dedup import DeduplicationHook, candidate_rows, local_rows, map_to_local, seed_lookup
from .device import DeviceTransferHook, PinMemoryHook
from .negatives import (
    HistoricalNegativeEdgeSamplerHook,
    RandomNegativeEdgeSamplerHook,
    TGBNegativeEdgeSamplerHook,
    TGBTHGNegativeEdgeSamplerHook,
    TGBTKGNegativeEdgeSamplerHook,
)
from .neighbors import NeighborSamplerHook, RecencyNeighborHook
from .node_tracks import EdgeEventsSeenNodesTrackHook
from .timegap import TimeGapNeighborMeanHook
from .analytics import BatchAnalyticsHook, NodeAnalyticsHook
from .recipe import RecipeRegistry, build_tgb_link_pred

__all__ = [
    "BaseDGHook",
    "BatchAnalyticsHook",
    "CORE_ATTRIBUTE",
    "DGHook",
    "DeduplicationHook",
    "DeviceTransferHook",
    "EdgeEventsSeenNodesTrackHook",
    "HistoricalNegativeEdgeSamplerHook",
    "HookManager",
    "NeighborSamplerHook",
    "NodeAnalyticsHook",
    "PinMemoryHook",
    "RandomNegativeEdgeSamplerHook",
    "RecencyNeighborHook",
    "RecipeRegistry",
    "SeedableHook",
    "StatefulHook",
    "StatelessHook",
    "TGBNegativeEdgeSamplerHook",
    "TGBTHGNegativeEdgeSamplerHook",
    "TGBTKGNegativeEdgeSamplerHook",
    "TimeGapNeighborMeanHook",
    "build_tgb_link_pred",
    "hook",
    "list_hooks",
    "candidate_rows",
    "local_rows",
    "map_to_local",
    "seed_lookup",
]
