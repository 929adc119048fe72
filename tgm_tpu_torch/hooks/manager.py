"""HookManager: keyed hook sets with dependency-resolved execution.

Port of ``tgm_tpu/hooks/manager.py``: keyed and shared hooks, a Kahn
topological sort over requires/produces (with the implicit
negatives-before-neighbour-samplers edge), ``activate``, ``reset_state``,
``as_transform`` (the resolved pipeline as a function over the hooks' states),
``adopt_states``, ``validate_requirement`` (an encoder's ``requires``
against what a key's hooks produce, with ``difflib`` suggestions), and
``collect_states`` / ``load_states`` for checkpoints, keyed
``f"{i}:{hook!r}"`` as in JAX.
"""

from __future__ import annotations

import difflib
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

from ..core.batch import DGBatch
from ..core.graph import DGraph
from ..exceptions import (
    BadEncoderProtocolError,
    BadHookProtocolError,
    UnresolvableHookDependenciesError,
)
from .base import DGHook
from .registry import list_hooks

# Attributes always present on a batch (never hook-produced).
CORE_ATTRIBUTE: Set[str] = {
    "edge_src",
    "edge_dst",
    "edge_time",
    "edge_valid",
    "edge_ids",
    "edge_type",
    "node_x_time",
    "node_x_nids",
    "node_y_time",
    "node_y_nids",
    "node_type",
}


class HookManager:
    """Manages shared + key-specific hook sets for batch enrichment."""

    def __init__(self, keys: List[str]) -> None:
        if not len(keys):
            raise ValueError("HookManager keys list must be non-empty")
        self._dirty: Dict[str, bool] = {k: True for k in keys}
        self._key_to_hooks: Dict[str, List[DGHook]] = {k: [] for k in keys}
        self._shared_hooks: List[DGHook] = []
        self._active_key: Optional[str] = None

    @property
    def keys(self) -> List[str]:
        return list(self._key_to_hooks)

    def register_shared(self, hook: DGHook) -> None:
        self._ensure_valid_hook(hook)
        self._ensure_no_active_key()
        self._shared_hooks.append(hook)
        for k in self._dirty:
            self._dirty[k] = True

    def register(self, key: str, hook: DGHook) -> None:
        self._ensure_valid_key(key)
        self._ensure_valid_hook(hook)
        self._ensure_no_active_key()
        self._key_to_hooks[key].append(hook)
        self._dirty[key] = True

    def set_active_hooks(self, key: str) -> None:
        self._ensure_valid_key(key)
        self._active_key = key

    @contextmanager
    def activate(self, key: str) -> Iterator[None]:
        prev = self._active_key
        self.set_active_hooks(key)
        try:
            yield
        finally:
            self._active_key = prev

    @property
    def active_key(self) -> Optional[str]:
        return self._active_key

    def execute_active_hooks(self, dg: DGraph, batch: DGBatch) -> DGBatch:
        if self._active_key is None:
            raise RuntimeError("No active key set. Use activate() context manager.")
        for hook in self._resolved(self._active_key):
            batch = hook(dg, batch)
        return batch

    def reset_state(self, key: Optional[str] = None) -> None:
        if key is not None:
            self._ensure_valid_key(key)
        for hook in self._shared_hooks:
            hook.reset_state()
        for k in [key] if key is not None else list(self._key_to_hooks):
            for h in self._key_to_hooks[k]:
                h.reset_state()

    def resolve_hooks(self, key: Optional[str] = None) -> None:
        if key is not None:
            self._ensure_valid_key(key)
        for k in [key] if key else list(self._key_to_hooks):
            hooks = self._shared_hooks + [
                h for h in self._key_to_hooks[k] if h not in self._shared_hooks
            ]
            self._key_to_hooks[k] = self._topological_sort_hooks(hooks)
            self._dirty[k] = False

    def _resolved(self, key: str) -> List[DGHook]:
        if self._dirty[key]:
            self.resolve_hooks(key)
        return self._key_to_hooks[key]

    @staticmethod
    def _topological_sort_hooks(hooks: List[DGHook]) -> List[DGHook]:
        all_produced: Set[str] = set(CORE_ATTRIBUTE)
        for h in hooks:
            all_produced |= h.produces
        missing: Set[str] = set()
        for h in hooks:
            missing |= h.requires - all_produced
        if missing:
            raise UnresolvableHookDependenciesError(
                f"Cannot resolve hook dependencies: required attributes not produced "
                f"by any hook: {missing}"
            )

        adj: Dict[DGHook, List[DGHook]] = defaultdict(list)
        is_neg = lambda h: "neg" in h.produces
        is_nbr = lambda h: any("nbr_nids" in p for p in h.produces)
        for h1 in hooks:
            for h2 in hooks:
                if h1 is h2:
                    continue
                if h1.produces & h2.requires:
                    adj[h1].append(h2)
                # Negatives before neighbour samplers, so neighbour queries
                # cover the negative seeds.
                if is_neg(h1) and is_nbr(h2):
                    adj[h1].append(h2)

        indeg: Dict[DGHook, int] = {h: 0 for h in hooks}
        for vs in adj.values():
            for v in vs:
                indeg[v] += 1
        queue = deque([h for h in hooks if indeg[h] == 0])
        ordered: List[DGHook] = []
        while queue:
            u = queue.popleft()
            ordered.append(u)
            for v in adj.get(u, []):
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        if len(ordered) != len(hooks):
            unresolved = [h for h in hooks if h not in ordered]
            raise UnresolvableHookDependenciesError(
                f"Cannot resolve hook dependencies: {unresolved} stuck in a cycle"
            )
        return ordered

    def validate_requirement(self, module: Any, key: Optional[str] = None) -> None:
        """Raise unless the hooks of ``key`` (every key by default), shared
        ones included, produce every attribute ``module.requires`` names."""
        from ..nn.base import EncoderModule

        if not isinstance(module, EncoderModule):
            raise BadEncoderProtocolError(
                f"Cannot validate {type(module).__name__}: must implement "
                "__call__(self, batch, *args, **kwargs) and have a `requires` attribute"
            )
        if key is not None:
            self._ensure_valid_key(key)
        for k in [key] if key else list(self._key_to_hooks):
            hooks = self._shared_hooks + [
                h for h in self._key_to_hooks[k] if h not in self._shared_hooks
            ]
            produced = set(CORE_ATTRIBUTE)
            for h in hooks:
                produced |= h.produces
            unresolved = set(module.requires) - produced
            if not unresolved:
                continue
            suggestions = [f"  - {attr!r}: {self._suggest(attr, produced, k)}"
                           for attr in sorted(unresolved)]
            raise UnresolvableHookDependenciesError(
                f"Cannot resolve the following requirements {unresolved} from any "
                f"hook registered under key {k!r}.\nSuggestions:\n" + "\n".join(suggestions)
            )

    @staticmethod
    def _suggest(attr: str, produced: Set[str], key: str) -> str:
        close = difflib.get_close_matches(attr, produced, n=2, cutoff=0.6)
        if close:
            alts = " or ".join(repr(c) for c in close)
            return (
                f"Do you mean {alts}? If so, update the module requirement with the "
                f"correct name."
            )
        # Scan the registered hook classes for the keyword in produces or docs.
        for cls in list_hooks():
            doc = (cls.__doc__ or "").lower()
            if attr in getattr(cls, "_cls_produces", set()) or attr.lower() in doc:
                return (
                    f"Found keyword {attr!r} in {cls.__name__!r}. If this hook produces "
                    f"what you are looking for, register {cls.__name__!r} with key {key!r}."
                )
        return "Can not find any existing hooks that satisfy this requirement."

    def as_transform(
        self, key: str, dg: DGraph
    ) -> Tuple[Callable[[List[Any], DGBatch], Tuple[List[Any], DGBatch]], List[Any]]:
        """The resolved pipeline for ``key`` as ``(fn, init_states)``.

        ``fn(states, batch)`` applies every hook's ``apply`` in topological
        order. Live hook state (e.g. recency buffers carried over from a
        previous split) is reused; a freshly initialized state is kept on the
        hook so a repeated export starts from the same state.
        """
        hooks = self._resolved(key)

        def state_of(h: DGHook) -> Any:
            if not h.has_state:
                return None
            if h.state is None:
                h.state = h.init_state(dg)
            return h.state

        states = [state_of(h) for h in hooks]

        def fn(states: List[Any], batch: DGBatch) -> Tuple[List[Any], DGBatch]:
            out_states = []
            for h, s in zip(hooks, states):
                s, batch = h.apply(s, batch)
                out_states.append(s)
            return out_states, batch

        return fn, states

    def adopt_states(self, key: str, states: List[Any]) -> None:
        """Store an epoch's final hook states back on the hook objects
        (aligned with ``as_transform``'s hook order)."""
        hooks = self._resolved(key)
        if len(hooks) != len(states):
            raise ValueError(f"adopt_states: got {len(states)} states for {len(hooks)} hooks")
        for h, s in zip(hooks, states):
            if h.has_state:
                h.state = s

    def collect_states(self) -> Dict[str, Any]:
        """Every stateful hook's state, for checkpoints: ``{"shared": {name:
        state}, "keyed": {key: {name: state}}}`` with ``name = f"{i}:{hook!r}"``
        (``i`` the hook's place in its list)."""
        out: Dict[str, Any] = {"shared": {}, "keyed": {}}
        for i, h in enumerate(self._shared_hooks):
            if h.has_state:
                out["shared"][f"{i}:{h!r}"] = getattr(h, "state", None)
        for k, hooks in self._key_to_hooks.items():
            out["keyed"][k] = {}
            for i, h in enumerate(hooks):
                if h.has_state and h not in self._shared_hooks:
                    out["keyed"][k][f"{i}:{h!r}"] = getattr(h, "state", None)
        return out

    def load_states(self, states: Dict[str, Any]) -> None:
        """Put ``collect_states``' states back on the hooks whose names match."""
        for i, h in enumerate(self._shared_hooks):
            name = f"{i}:{h!r}"
            if h.has_state and name in states.get("shared", {}):
                h.state = states["shared"][name]
        for k, hooks in self._key_to_hooks.items():
            keyed = states.get("keyed", {}).get(k, {})
            for i, h in enumerate(hooks):
                name = f"{i}:{h!r}"
                if h.has_state and name in keyed and h not in self._shared_hooks:
                    h.state = keyed[name]

    def _ensure_valid_hook(self, hook: Any) -> None:
        if not isinstance(hook, DGHook):
            raise BadHookProtocolError(
                f"Cannot register hook {type(hook).__name__}: must implement "
                "__call__(dg, batch) -> batch, reset_state(), requires and produces."
            )

    def _ensure_no_active_key(self) -> None:
        if self._active_key is not None:
            raise RuntimeError(
                "Cannot register hooks while a key is active. Register hooks "
                "before using `activate`."
            )

    def _ensure_valid_key(self, key: str) -> None:
        if key not in self._key_to_hooks:
            raise KeyError(f"{key} was not a declared key in the hook manager")

    def __str__(self) -> str:
        lines = ["HookManager:", "  Shared hooks:"]
        for h in self._shared_hooks:
            lines.append(f"    - {h!r} (requires={h.requires}, produces={h.produces})")
        lines.append(f"  Active key: {self._active_key}")
        lines.append("  Keyed hooks:")
        for key, hooks in self._key_to_hooks.items():
            lines.append(f"    {key}:")
            for h in hooks:
                lines.append(f"    - {h!r} (requires={h.requires}, produces={h.produces})")
        return "\n".join(lines)
