"""Optimizers of the port (:mod:`.updaters`)."""

from .updaters import (AdamUpdater, NAGUpdater, SGDUpdater, Updater,
                       UpdaterHyper, create_updater)

__all__ = ["AdamUpdater", "NAGUpdater", "SGDUpdater", "Updater",
           "UpdaterHyper", "create_updater"]
