# Copied from catch_tpu/utils/log.py.
"""Logging configuration (parity: reference catch/utils/log.py)."""

import logging


def configure_logging(level=logging.WARNING):
    fmt = "[%(asctime)s - %(name)s:%(lineno)d - %(levelname)s] %(message)s"
    logging.basicConfig(format=fmt, level=level)
