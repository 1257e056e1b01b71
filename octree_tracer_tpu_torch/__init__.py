"""octree_tracer_tpu_torch: the renderer ported to PyTorch and CUDA (Hopper).

The package sits beside ``octree_tracer_tpu`` (the JAX reference) and mirrors
its module paths. It imports ``torch`` and no module of JAX or of the JAX
package. The main path is ``render.tracer.render_frame`` on rays from
``render.camera.generate_rays_device`` with a table from
``render.skip.build_warp_skip_table``; on a CUDA device it runs five
hand-written kernels (``csrc/``, built by ``kernels``), on the CPU their plain
PyTorch versions.
"""

__version__ = "0.1.0"
