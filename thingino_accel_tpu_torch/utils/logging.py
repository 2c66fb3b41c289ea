"""Structured logging.

Port of ``thingino_accel_tpu.utils.logging``: one stdlib logger, its
level from ``TAT_LOG``, quiet by default, since the engine is a library.
"""

from __future__ import annotations

import logging

from thingino_accel_tpu_torch.utils import config

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR}


def get_logger(name: str = "tat") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "[%(levelname).1s %(asctime)s %(name)s] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(_LEVELS.get(config.get("TAT_LOG").lower(),
                                    logging.WARNING))
        logger.propagate = False
    return logger
