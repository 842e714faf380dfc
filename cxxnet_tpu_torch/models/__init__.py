"""Netconfig generators (:mod:`.zoo`)."""

from .zoo import (alexnet, googlenet, lenet, mlp, resnet,  # noqa: F401
                  transformer, vgg)
