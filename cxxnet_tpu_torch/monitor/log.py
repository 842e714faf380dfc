"""Stdlib logging behind the CLI's historical print surface.

Every ``print`` in trainer/main used one of four shapes; each gets a
function here, keeping the exact line format (handlers format records as
bare ``%(message)s``, so output-scraping consumers see byte-identical
lines):

* :func:`info`   — progress chatter, stdout, suppressed by ``silent = 1``
* :func:`notice` — task milestones ("start predicting..."), stdout,
  printed regardless of ``silent`` (parity with the reference CLI)
* :func:`result` — evaluation lines (``[r]\\ttrain-error:...``), stderr,
  never suppressed (round results are the product, not chatter)
* :func:`warn`   — warnings/exceedances, stderr, never suppressed

``silent`` maps to levels — :func:`set_silent` moves the stdout logger
between INFO and WARNING; ``notice`` emits at WARNING so it survives.
The mapping is process-global (like the loggers themselves): the last
component to set ``silent`` wins, which matches the CLI where one task
owns the process.  :func:`mute` silences a process for good (the data
mesh's ranks other than rank 0).

Handlers resolve ``sys.stdout``/``sys.stderr`` at emit time, so output
lands wherever the descriptor points *now* (pytest capsys, pipe
redirection after import, notebook cell capture).
"""

from __future__ import annotations

import logging
import sys

_FMT = logging.Formatter("%(message)s")


class _DynamicStreamHandler(logging.StreamHandler):
    """StreamHandler that looks up the stream by name on every emit."""

    def __init__(self, stream_name: str):
        self._stream_name = stream_name
        super().__init__()

    @property
    def stream(self):
        return getattr(sys, self._stream_name)

    @stream.setter
    def stream(self, value):  # base __init__ assigns; the name wins
        pass


def _build(name: str, stream_name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.propagate = False
    if not logger.handlers:
        h = _DynamicStreamHandler(stream_name)
        h.setFormatter(_FMT)
        logger.addHandler(h)
    logger.setLevel(logging.INFO)
    return logger


_out = _build("cxxnet_tpu_torch.out", "stdout")
_err = _build("cxxnet_tpu_torch.err", "stderr")


_muted = False


def set_silent(flag) -> None:
    """``silent = 1`` suppresses info-level chatter (stdout logger to
    WARNING); results/warnings/notices still print."""
    if not _muted:
        _out.setLevel(logging.WARNING if int(flag) else logging.INFO)


def mute() -> None:
    """Silence every line but errors for the rest of the process: a
    data-mesh rank other than rank 0, which alone prints."""
    global _muted
    _muted = True
    _out.setLevel(logging.ERROR)
    _err.setLevel(logging.ERROR)


def is_silent() -> bool:
    return _out.level > logging.INFO


def info(msg: str) -> None:
    _out.info(msg)


def notice(msg: str) -> None:
    _out.warning(msg)


def result(msg: str) -> None:
    _err.info(msg)


def warn(msg: str) -> None:
    _err.warning(msg)
