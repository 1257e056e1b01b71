"""Rendering: camera, traversal, tables, shading."""
