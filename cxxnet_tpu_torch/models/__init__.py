"""Netconfig generators (:mod:`.zoo`)."""

from .zoo import alexnet, lenet, transformer  # noqa: F401
