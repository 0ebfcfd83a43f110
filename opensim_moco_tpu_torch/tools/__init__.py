"""Tools of the port (numpy and torch only, no ``jax``)."""

from .inverse import Inverse
from .track import Track

__all__ = ["Inverse", "Track"]
