"""World: chunk store, mip trees, chunk streaming."""

from .world import BLOCK_NAMES, World

__all__ = ["BLOCK_NAMES", "World"]
