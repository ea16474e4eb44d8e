"""Stdout/stderr tee into a log file (the training run's log.txt).

Copy of `gnerf_tpu/utils/logger.py`."""

from __future__ import annotations

import sys
from typing import Optional


class Logger:
    """Tees writes to stdout and stderr into a log file. Use as a context
    manager or call close(), which puts the original streams back."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "a",
                 should_flush: bool = True):
        self.file = open(file_name, mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
