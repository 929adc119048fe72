"""Structured logging, metric and latency records (port of
``tgm_tpu/util/logging.py``).

Logging is off unless the ``TGM_LOGGING_ENABLED`` environment variable
says ``1``/``true``/``yes`` or ``enable_logging`` is called. Metrics go out
human-readable at INFO and as one JSON object per line at DEBUG
(``{"metric": ..., "value": ...}``, what ``tools/log_parser.py`` reads).
``log_latency`` and ``log_device_mem`` decorate functions; the latter reads
``torch.cuda.memory_allocated`` of the card its call's tensors live on.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

_LOGGER_NAME = "tgm_tpu_torch"
_ENV_FLAG = "TGM_LOGGING_ENABLED"

_logging_enabled = os.environ.get(_ENV_FLAG, "").lower() in ("1", "true", "yes")


def _get_logger(name: Optional[str] = None) -> logging.Logger:
    if name is None or name == _LOGGER_NAME:
        return logging.getLogger(_LOGGER_NAME)
    if not name.startswith(_LOGGER_NAME):
        name = f"{_LOGGER_NAME}.{name}"
    return logging.getLogger(name)


def enable_logging(
    log_level: int = logging.INFO,
    log_file_path: Optional[str] = None,
    file_log_level: int = logging.DEBUG,
) -> None:
    """Turn on the package's logging with a console (and optional file) handler."""
    global _logging_enabled
    _logging_enabled = True

    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(min(log_level, file_log_level) if log_file_path else log_level)
    logger.handlers.clear()

    console = logging.StreamHandler()
    console.setLevel(log_level)
    console.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(console)

    if log_file_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_file_path)), exist_ok=True)
        fh = logging.FileHandler(log_file_path)
        fh.setLevel(file_log_level)
        fh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(fh)


def is_logging_enabled() -> bool:
    return _logging_enabled


def log_metric(metric: str, value: Any, **extra: Any) -> None:
    """Emit a metric: human-readable at INFO, a JSON record at DEBUG."""
    logger = _get_logger()
    logger.info("%s = %s", metric, pretty_number_format(value))
    record: Dict[str, Any] = {"metric": metric, "value": _jsonable(value)}
    record.update({k: _jsonable(v) for k, v in extra.items()})
    logger.debug(json.dumps(record))


def log_metrics_dict(metrics: Dict[str, Any], prefix: str = "") -> None:
    for k, v in metrics.items():
        log_metric(f"{prefix}{k}", v)


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)


def log_latency(fn: Optional[Callable] = None, *, level: int = logging.DEBUG) -> Callable:
    """Decorator: time the wrapped call (host clock) and emit a JSON latency
    record. Work the call queued on the card is not waited for."""

    def decorate(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not _logging_enabled:
                return f(*args, **kwargs)
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            dt = time.perf_counter() - t0
            _get_logger().log(level, json.dumps(
                {"metric": f"latency_{f.__qualname__}", "value": dt, "unit": "s"}))
            return out

        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


def _cuda_device(*objs: Any) -> Optional[torch.device]:
    """The device of the first CUDA tensor among ``objs`` (searched into
    tuples, lists and dict values), or None."""
    for o in objs:
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                return o.device
        elif isinstance(o, (tuple, list)):
            d = _cuda_device(*o)
            if d is not None:
                return d
        elif isinstance(o, dict):
            d = _cuda_device(*o.values())
            if d is not None:
                return d
    return None


def log_device_mem(fn: Optional[Callable] = None, *, level: int = logging.DEBUG) -> Callable:
    """Decorator: after the wrapped call, log ``torch.cuda.memory_allocated``
    of the card that holds its output's tensors (else its arguments'). A
    call that touches no CUDA tensor logs nothing."""

    def decorate(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            out = f(*args, **kwargs)
            if _logging_enabled:
                dev = _cuda_device(out, args, kwargs)
                if dev is not None:
                    _get_logger().log(level, json.dumps(
                        {"metric": f"device_mem_{f.__qualname__}",
                         "value": int(torch.cuda.memory_allocated(dev)), "unit": "bytes"}))
            return out

        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


def pretty_number_format(v: Any) -> str:
    """Human formatting: 1234567 -> '1.23M'."""
    try:
        x = float(v)
    except (TypeError, ValueError):
        return str(v)
    if x != x:  # nan
        return "nan"
    for thresh, suffix in ((1e12, "T"), (1e9, "B"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= thresh:
            return f"{x / thresh:.2f}{suffix}"
    if x == int(x):
        return str(int(x))
    return f"{x:.4f}"


__all__ = ["enable_logging", "is_logging_enabled", "log_device_mem", "log_latency", "log_metric",
           "log_metrics_dict", "pretty_number_format"]
