from .base import BaseDGHook, DGHook, SeedableHook, StatefulHook, StatelessHook
from .dedup import DeduplicationHook, candidate_rows, local_rows, map_to_local, seed_lookup
from .manager import HookManager
from .negatives import RandomNegativeEdgeSamplerHook, TGBNegativeEdgeSamplerHook
from .neighbors import RecencyNeighborHook
from .registry import hook, list_hooks

__all__ = [
    "BaseDGHook",
    "DGHook",
    "DeduplicationHook",
    "HookManager",
    "RandomNegativeEdgeSamplerHook",
    "RecencyNeighborHook",
    "SeedableHook",
    "StatefulHook",
    "StatelessHook",
    "TGBNegativeEdgeSamplerHook",
    "candidate_rows",
    "hook",
    "list_hooks",
    "local_rows",
    "map_to_local",
    "seed_lookup",
]
