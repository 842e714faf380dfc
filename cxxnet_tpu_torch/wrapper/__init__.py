from .api import DataIter, Net, ServingHost, train

__all__ = ["DataIter", "Net", "ServingHost", "train"]
