from .bevnet import BEVNet, positional_encoding

__all__ = ["BEVNet", "positional_encoding"]
