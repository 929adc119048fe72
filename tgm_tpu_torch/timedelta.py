"""Time-granularity algebra for temporal graphs (port of ``tgm_tpu/timedelta.py``,
copied whole): the unit table, the event-ordered 'r' unit,
``convert``/``is_coarser_than`` and the per-dataset granularity tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, Final, Union

from .exceptions import EventOrderedConversionError

_NANOS_PER: Dict[str, int] = {
    "Y": 1_000_000_000 * 60 * 60 * 24 * 365,
    "M": 1_000_000_000 * 60 * 60 * 24 * 30,
    "W": 1_000_000_000 * 60 * 60 * 24 * 7,
    "D": 1_000_000_000 * 60 * 60 * 24,
    "h": 1_000_000_000 * 60 * 60,
    "m": 1_000_000_000 * 60,
    "s": 1_000_000_000,
    "ms": 1_000_000,
    "us": 1_000,
    "ns": 1,
}

EVENT_ORDERED_UNIT: Final[str] = "r"


@dataclass(frozen=True)
class TimeDeltaDG:
    """Granularity of the temporal index of a dynamic graph.

    ``unit`` is one of Y/M/W/D/h/m/s/ms/us/ns for timed graphs, or the special
    ``'r'`` for event-ordered (purely sequential) indices. ``value`` is a
    positive integer multiplier (must be 1 for event-ordered).
    """

    unit: str
    value: int = 1

    _UNIT_TO_NANOS: ClassVar[Dict[str, int]] = _NANOS_PER

    def __post_init__(self) -> None:
        if not isinstance(self.value, int) or isinstance(self.value, bool) or self.value <= 0:
            raise ValueError(f"TimeDeltaDG value must be a positive int, got {self.value!r}")
        if self.unit == EVENT_ORDERED_UNIT:
            if self.value != 1:
                raise ValueError("event-ordered TimeDeltaDG only supports value=1")
        elif self.unit not in _NANOS_PER:
            allowed = [EVENT_ORDERED_UNIT, *list(_NANOS_PER)]
            raise ValueError(f"Unknown unit {self.unit!r}; expected one of {allowed}")

    @property
    def is_event_ordered(self) -> bool:
        return self.unit == EVENT_ORDERED_UNIT

    @property
    def is_time_ordered(self) -> bool:
        return not self.is_event_ordered

    def nanos(self) -> int:
        """Total nanoseconds represented by one tick of this granularity."""
        if self.is_event_ordered:
            raise EventOrderedConversionError("event-ordered granularity has no duration")
        return _NANOS_PER[self.unit] * self.value

    def convert(self, other: Union[str, "TimeDeltaDG"]) -> float:
        """Ratio of one tick of ``self`` to one tick of ``other``.

        ``TimeDeltaDG('h').convert('m') == 60.0``.
        """
        if isinstance(other, str):
            other = TimeDeltaDG(other)
        if self.is_event_ordered or other.is_event_ordered:
            raise EventOrderedConversionError(
                "Cannot convert granularity for event-ordered TimeDeltaDG"
            )
        a, b = _NANOS_PER[self.unit], _NANOS_PER[other.unit]
        # Integer-divide in the safe direction to avoid float precision loss on
        # huge nano counts, then fold in the value ratio.
        if a >= b:
            return (self.value / other.value) * (a // b)
        return (self.value / other.value) / (b // a)

    def is_coarser_than(self, other: Union[str, "TimeDeltaDG"]) -> bool:
        return self.convert(other) > 1

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.unit if self.value == 1 else f"{self.value}{self.unit}"


# Granularities of the public TGB datasets.
TGB_TIME_DELTAS: Final[Dict[str, TimeDeltaDG]] = {
    "tgbl-enron": TimeDeltaDG("s"),
    "tgbl-uci": TimeDeltaDG("s"),
    "tgbl-wiki": TimeDeltaDG("s"),
    "tgbl-subreddit": TimeDeltaDG("s"),
    "tgbl-lastfm": TimeDeltaDG("s"),
    "tgbl-review": TimeDeltaDG("s"),
    "tgbl-coin": TimeDeltaDG("s"),
    "tgbl-mooc": TimeDeltaDG("s"),
    "tgbl-flight": TimeDeltaDG("s"),
    "tgbl-comment": TimeDeltaDG("s"),
    "tgbn-trade": TimeDeltaDG("Y"),
    "tgbn-genre": TimeDeltaDG("s"),
    "tgbn-reddit": TimeDeltaDG("s"),
    "tgbn-token": TimeDeltaDG("s"),
    "thgl-software": TimeDeltaDG("s"),
    "thgl-forum": TimeDeltaDG("s"),
    "thgl-github": TimeDeltaDG("s"),
    "thgl-myket": TimeDeltaDG("s"),
    "tkgl-smallpedia": TimeDeltaDG("Y"),
    "tkgl-polecat": TimeDeltaDG("D"),
    "tkgl-icews": TimeDeltaDG("D"),
    "tkgl-wikidata": TimeDeltaDG("Y"),
}

TGB_SEQ_TIME_DELTAS: Final[Dict[str, TimeDeltaDG]] = {
    "ML-20M": TimeDeltaDG("s"),
    "Taobao": TimeDeltaDG("s"),
    "Yelp": TimeDeltaDG("s"),
    "GoogleLocal": TimeDeltaDG("s"),
    "Flickr": TimeDeltaDG("s"),
    "Youtube": TimeDeltaDG("s"),
    "Patent": TimeDeltaDG("s"),
    "WikiLink": TimeDeltaDG("s"),
}
