"""Logging: level from the LOG_LEVEL env var, plus device topology logged at
startup (this engine's analogue of the reference's CPU-feature detection,
reference: src/logging_layer.rs:4-47)."""

from __future__ import annotations

import logging
import os

_initialized = False


def initialize_logging() -> None:
    global _initialized
    if _initialized:
        return
    level = os.environ.get("LOG_LEVEL", "INFO").upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.INFO),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    _initialized = True


def log_device_topology() -> None:
    import jax

    log = logging.getLogger("fwt.topology")
    devices = jax.devices()
    log.info(
        "backend=%s devices=%d kinds=%s",
        jax.default_backend(),
        len(devices),
        sorted({d.device_kind for d in devices}),
    )


def get_logger(name: str) -> logging.Logger:
    initialize_logging()
    return logging.getLogger(name)
