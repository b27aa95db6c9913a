"""Logging utilities.

Parity with reference wdbx/utils/logging.py: root configuration with
console + rotating-file handlers (:13-75), a context-injecting adapter
(:99-148), and a ``ProgressLogger`` context manager emitting
percentage-interval progress with rate/ETA (:151-253).

Torch port: ``wdbx_tpu/utils/logging.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import logging
import logging.handlers
import time
from typing import Any


def configure_logging(
    level: str = "INFO",
    log_file: str | None = None,
    max_bytes: int = 10 * 1024 * 1024,
    backup_count: int = 3,
    fmt: str = "%(asctime)s %(name)s %(levelname)s %(message)s",
) -> None:
    """Configure the root logger with console and optional rotating file."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    formatter = logging.Formatter(fmt)
    console = logging.StreamHandler()
    console.setFormatter(formatter)
    root.handlers = [console]
    if log_file:
        rotating = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_bytes, backupCount=backup_count
        )
        rotating.setFormatter(formatter)
        root.addHandler(rotating)


def get_logger(name: str, context: dict[str, Any] | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if context:
        return ContextLogger(logger, context)  # type: ignore[return-value]
    return logger


class ContextLogger(logging.LoggerAdapter):
    """Prepends ``key=value`` context to every message."""

    def process(self, msg, kwargs):
        ctx = " ".join(f"{k}={v}" for k, v in (self.extra or {}).items())
        return (f"[{ctx}] {msg}" if ctx else msg), kwargs


class ProgressLogger:
    """Logs progress at percentage intervals with rate and ETA.

    >>> with ProgressLogger(logger, total=1000, operation="ingest") as p:
    ...     for item in items:
    ...         ...; p.update()
    """

    def __init__(
        self,
        logger: logging.Logger,
        total: int,
        operation: str = "operation",
        interval_pct: float = 10.0,
    ):
        self.logger = logger
        self.total = max(1, total)
        self.operation = operation
        self.interval_pct = interval_pct
        self.done = 0
        self._next_pct = interval_pct
        self._start = 0.0

    def __enter__(self) -> "ProgressLogger":
        self._start = time.perf_counter()
        self.logger.info("%s: starting (%d items)", self.operation, self.total)
        return self

    def update(self, n: int = 1) -> None:
        self.done += n
        pct = 100.0 * self.done / self.total
        if pct >= self._next_pct or self.done >= self.total:
            elapsed = max(time.perf_counter() - self._start, 1e-9)
            rate = self.done / elapsed
            remaining = (self.total - self.done) / rate if rate else 0.0
            self.logger.info(
                "%s: %.0f%% (%d/%d) %.1f items/s ETA %.1fs",
                self.operation, pct, self.done, self.total, rate, remaining,
            )
            while self._next_pct <= pct:
                self._next_pct += self.interval_pct

    def __exit__(self, exc_type, exc, tb) -> None:
        elapsed = time.perf_counter() - self._start
        if exc_type is None:
            self.logger.info(
                "%s: done (%d items in %.2fs, %.1f items/s)",
                self.operation, self.done, elapsed,
                self.done / max(elapsed, 1e-9),
            )
        else:
            self.logger.warning(
                "%s: failed after %d items (%.2fs): %s",
                self.operation, self.done, elapsed, exc,
            )
