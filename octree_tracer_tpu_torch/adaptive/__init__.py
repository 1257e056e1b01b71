"""Adaptive LOD: device candidate selection and visit closure, host engine."""
