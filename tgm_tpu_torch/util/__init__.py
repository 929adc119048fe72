from .logging import (
    enable_logging,
    log_device_mem,
    log_latency,
    log_metric,
    log_metrics_dict,
    pretty_number_format,
)
from .seed import get_seed, seed_everything

__all__ = [
    "enable_logging",
    "get_seed",
    "log_device_mem",
    "log_latency",
    "log_metric",
    "log_metrics_dict",
    "pretty_number_format",
    "seed_everything",
]
