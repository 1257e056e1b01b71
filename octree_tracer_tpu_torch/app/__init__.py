"""Application layer: interactive session, headless rendering, CLI and
viewer.

Submodules import lazily, so CLI paths that never render (``export``) do
not touch a device.
"""

__all__ = ["Character", "Session", "Settings"]


def __getattr__(name):
    if name in __all__:
        from . import session

        return getattr(session, name)
    raise AttributeError(name)
