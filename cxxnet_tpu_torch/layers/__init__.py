"""Layers of the port: configuration objects whose ``forward`` is a
plain function on tensors (see :mod:`.base`)."""
