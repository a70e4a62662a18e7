"""Logging setup of the port's CLIs.

Copy of ``cut_detection_tpu/utils/logging.py``: the reference's one
format string (segment_video.py:14-17) in one helper.
"""

from __future__ import annotations

import logging

LOG_FORMAT = (
    "[%(asctime)s] %(levelname)s [%(name)s.%(funcName)s:%(lineno)d] %(message)s"
)


def setup_logging(level: str = "INFO") -> None:
    logging.basicConfig(level=level, format=LOG_FORMAT)
