"""Node word format (the JAX package's ``core/voxel.py``).

A pool word is ``(payload << 4) | counter``. ``payload < VOXEL_OFFSET`` is the
index of the node's 8-child group; otherwise the node is a leaf and
``payload - VOXEL_OFFSET`` its RGB888 colour (0 = empty).
"""

VOXEL_OFFSET = 1 << 27
