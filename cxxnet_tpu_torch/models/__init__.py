"""Netconfig generators (:mod:`.zoo`)."""

from .zoo import transformer  # noqa: F401
