"""Adaptive LOD: device candidate selection and visit closure, host engine."""

from . import engine, feedback
from .engine import process_subdivision, process_unsubdivision
from .feedback import (
    MAX_SUBDIVISIONS_PER_FRAME,
    MAX_UNSUBDIVISIONS_PER_FRAME,
    apply_patches,
    pad_patches,
    select_candidates,
    select_candidates_packed,
)

__all__ = [
    "engine", "feedback", "process_subdivision", "process_unsubdivision",
    "MAX_SUBDIVISIONS_PER_FRAME", "MAX_UNSUBDIVISIONS_PER_FRAME",
    "apply_patches", "pad_patches", "select_candidates", "select_candidates_packed",
]
