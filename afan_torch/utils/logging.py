"""Static logger, a copy of ``afan/utils/logging.py`` (port of
`Detection/logger.py`: python logging with
file + stream handlers behind a class-method facade)."""
from __future__ import annotations

import logging
import sys
from typing import Optional


class Log:
    _logger: Optional[logging.Logger] = None

    @classmethod
    def initialize(cls, path_to_log_file: Optional[str] = None,
                   quiet: bool = False) -> None:
        """Log to stdout and ``path_to_log_file``; ``quiet`` (a
        data-parallel rank other than 0) keeps warnings and errors only."""
        logger = logging.getLogger("afan_torch")
        logger.setLevel(logging.WARNING if quiet else logging.INFO)
        logger.handlers.clear()
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s", "%Y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if path_to_log_file:
            fh = logging.FileHandler(path_to_log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        cls._logger = logger

    @classmethod
    def _get(cls) -> logging.Logger:
        if cls._logger is None:
            cls.initialize()
        return cls._logger

    @classmethod
    def i(cls, msg: str) -> None:
        cls._get().info(msg)

    @classmethod
    def w(cls, msg: str) -> None:
        cls._get().warning(msg)

    @classmethod
    def e(cls, msg: str) -> None:
        cls._get().error(msg)
