from .logging import (
    enable_logging,
    log_device_mem,
    log_latency,
    log_metric,
    log_metrics_dict,
    pretty_number_format,
)
from .precision import resolve_bf16, tpu_default_bf16
from .seed import get_seed, seed_everything

__all__ = [
    "enable_logging",
    "get_seed",
    "log_device_mem",
    "log_latency",
    "log_metric",
    "log_metrics_dict",
    "pretty_number_format",
    "resolve_bf16",
    "seed_everything",
    "tpu_default_bf16",
]
