"""Tools of the port (numpy and torch only, no ``jax``)."""

from .inverse import Inverse

__all__ = ["Inverse"]
