"""Procedural generation: the island SDF evaluated on the card (kernel K7),
the chunk trees built on the host."""

from .noise import sdf_box, sdf_cone, simplex_noise3, smin, smoothstep
from .procedural import GenSettings, Procedural
from .sdf import island_sdf

__all__ = [
    "GenSettings", "Procedural", "island_sdf", "sdf_box", "sdf_cone",
    "simplex_noise3", "smin", "smoothstep",
]
