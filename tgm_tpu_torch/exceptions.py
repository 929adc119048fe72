"""Exceptions of the port (port of ``tgm_tpu/exceptions.py``)."""


class TGMError(Exception):
    """Base class for all framework errors."""


class BadHookProtocolError(TGMError):
    """A registered hook does not satisfy the DGHook protocol."""


class BadEncoderProtocolError(TGMError):
    """A module does not satisfy the EncoderModule protocol."""


class BadAggregatorProtocolError(TGMError):
    """An aggregator does not satisfy the Aggregator protocol."""


class UnresolvableHookDependenciesError(TGMError):
    """The hook requires/produces graph has a cycle or missing producer."""


class InvalidNodeIDError(TGMError):
    """A node id is out of range or collides with the padding sentinel."""


class EmptyGraphError(TGMError):
    """An operation that needs events was attempted on an empty graph."""


class CheckpointError(TGMError):
    """Checkpoint save/restore failed or state tree mismatch."""


class EmptyBatchError(TGMError):
    """A materialized batch contains no events and skip_empty is disabled."""


class EventOrderedConversionError(TGMError):
    """Tried to convert an event-ordered ('r') granularity to a timed one."""


class InvalidDiscretizationError(TGMError):
    """Discretization target granularity is finer than the current one."""


class UndefinedRecipeError(TGMError):
    """A recipe name was not registered in the RecipeRegistry."""


class InvalidBatchUnitError(TGMError):
    """Loader batch unit is incompatible with the graph's time granularity."""


class SplitStrategyError(TGMError):
    """Split configuration is invalid or applied twice."""
