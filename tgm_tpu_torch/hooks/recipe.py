"""Pre-defined hook-manager recipes (port of ``tgm_tpu/hooks/recipe.py``).

``RecipeRegistry`` maps names to callables that build a ready-to-use
``HookManager``; the TGB link-prediction recipe registers a random negative
sampler over the training graph's destination-id range for train and the
pre-generated TGB candidates for val and test.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..constants import RECIPE_TGB_LINK_PRED
from ..core.graph import DGraph
from ..device import DeviceLike
from ..exceptions import UndefinedRecipeError
from .manager import HookManager
from .negatives import RandomNegativeEdgeSamplerHook, TGBNegativeEdgeSamplerHook

logger = logging.getLogger(__name__)


class RecipeRegistry:
    """Registry of named pre-experiment setups (each returns a HookManager)."""

    _recipes: Dict[str, Callable] = {}

    @classmethod
    def register(cls, name: str) -> Callable:
        def decorator(func: Callable) -> Callable:
            cls._recipes[name] = func
            return func

        return decorator

    @classmethod
    def build(cls, name: str, **kwargs: Any) -> Any:
        if name not in cls._recipes:
            raise UndefinedRecipeError(
                f"Undefined or unregistered recipe: {name}. "
                f"Available: {sorted(cls._recipes)}"
            )
        return cls._recipes[name](**kwargs)


@RecipeRegistry.register(RECIPE_TGB_LINK_PRED)
def build_tgb_link_pred(
    dataset_name: str,
    train_dg: DGraph,
    val_candidates: Optional[np.ndarray] = None,
    test_candidates: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> HookManager:
    """HookManager with keys [train, val, test] for TGB link prediction.

    ``val_candidates`` / ``test_candidates`` inject pre-generated negative
    sets directly; otherwise they are loaded from the installed TGB dataset
    files. The hooks run on ``device`` (default ``cuda``).
    """
    dst = train_dg.edge_dst
    hm = HookManager(keys=["train", "val", "test"])
    hm.register("train", RandomNegativeEdgeSamplerHook(low=int(dst.min()), high=int(dst.max()),
                                                       device=device))
    for split, cands in (("val", val_candidates), ("test", test_candidates)):
        if cands is not None:
            hook = TGBNegativeEdgeSamplerHook(cands, device=device)
        else:
            hook = TGBNegativeEdgeSamplerHook(dataset_name=dataset_name, split_mode=split,
                                              device=device)
        hm.register(split, hook)
    logger.info("Built %s HookManager for %s", RECIPE_TGB_LINK_PRED, dataset_name)
    return hm
