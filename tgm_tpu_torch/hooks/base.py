"""Hook protocol and base classes (port of ``tgm_tpu/hooks/base.py``).

A stateful hook's state is an explicit value (tensors) factored out of the
hook, as in the JAX package: ``apply(state, batch) -> (state, batch)`` is the
transition, ``__call__(dg, batch)`` the eager convenience wrapper that lazily
initializes the state from the graph and keeps it on the instance. Unlike the
JAX transitions, ``apply`` may update the state's tensors in place.
"""

from __future__ import annotations

from abc import ABC
from typing import Any, List, Optional, Protocol, Set, Tuple, runtime_checkable

from ..core.batch import DGBatch
from ..core.graph import DGraph


@runtime_checkable
class DGHook(Protocol):
    """Behaviors executed on each batch during iteration."""

    has_state: bool

    @property
    def requires(self) -> Set[str]: ...

    @property
    def produces(self) -> Set[str]: ...

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch: ...

    def reset_state(self) -> None: ...


class BaseDGHook(ABC):
    """Common machinery: requires/produces resolution and id suffixing."""

    _cls_requires: Set[str] = set()
    _cls_produces: Set[str] = set()

    has_state: bool = False

    def __init__(
        self,
        requires: Optional[Set[str]] = None,
        produces: Optional[Set[str]] = None,
        id: Optional[str] = None,
    ) -> None:
        self._requires: Set[str] = set(requires or set()) | set(self._cls_requires)
        self._produces: Set[str] = set(produces or set()) | set(self._cls_produces)
        self._id = id
        self.state: Any = None

    @property
    def requires(self) -> Set[str]:
        return self._requires

    @property
    def produces(self) -> Set[str]:
        if self._id is None:
            return self._produces
        return {f"{p}_{self._id}" for p in self._produces}

    def __repr__(self) -> str:
        name = type(self).__name__
        return f"{name}_{self._id}" if self._id else name

    def add_batch_attribute(self, batch: DGBatch, name: str, value: Any) -> None:
        """Attach ``value`` to the batch (suffixed with the hook id if set)."""
        if self._id:
            name = f"{name}_{self._id}"
        setattr(batch, name, value)

    def get_batch_attribute(self, batch: DGBatch, name: str) -> Any:
        """Read ``name`` from the batch (suffixed with the hook id if set)."""
        if self._id:
            name = f"{name}_{self._id}"
        return getattr(batch, name)

    def init_state(self, dg: Optional[DGraph]) -> Any:
        """This hook's initial state (None if stateless)."""
        return None

    def apply(self, state: Any, batch: DGBatch) -> Tuple[Any, DGBatch]:
        """Transition ``(state, batch) -> (state, batch')``."""
        raise NotImplementedError

    def __call__(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        if self.has_state and self.state is None:
            self.state = self.init_state(dg)
        self.state, batch = self.apply(self.state, batch)
        return batch

    def reset_state(self) -> None:
        self.state = None


class StatelessHook(BaseDGHook):
    has_state: bool = False


class StatefulHook(BaseDGHook):
    has_state: bool = True


class SeedableHook(BaseDGHook):
    """Hooks that read extra batch attributes named by ``seed_keys``."""

    def __init__(self, *args: Any, seed_keys: Optional[List[str]] = None, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.seed_keys: List[str] = list(seed_keys or [])
        self._requires.update(self.seed_keys)
