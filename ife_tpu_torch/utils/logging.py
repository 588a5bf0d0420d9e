"""Leveled logging + structured JSON metric lines (ife_tpu/utils/logging.py,
which has no JAX in it, carried over with the port's rank variable).

stdlib logging with a process-role prefix plus one-line JSON metric records
that downstream tooling can grep.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict

_FMT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def _process_tag() -> str:
    # the rank that parallel/launcher.py's distributed_init reads
    idx = os.environ.get("IFE_PROCESS_ID")
    return f"p{idx}" if idx is not None else ""


def get_logger(name: str = "ife") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        tag = _process_tag()
        fmt = _FMT if not tag else _FMT.replace("%(name)s", f"%(name)s/{tag}")
        h.setFormatter(logging.Formatter(fmt, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("IFE_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger


def log_json(event: str, payload: Dict[str, Any], stream=None) -> None:
    """One JSON metrics line: {"event": ..., "t": unix_time, ...}."""
    rec = {"event": event, "t": round(time.time(), 3)}
    rec.update(payload)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)
