"""jaderaytracerendering_tpu_torch — the path tracer on PyTorch and CUDA.

The port of ``jaderaytracerendering_tpu`` (JAX/Pallas) to PyTorch, with
the kernels written by hand in CUDA C++ for Hopper (``csrc/``). Module
paths mirror the JAX package's, so each file has one counterpart there.
The JAX package is the reference; this package never imports ``jax``.

- ``core``       counter RNG, plane-form vector math, camera, film.
- ``scene``      host-side NumPy scene building (meshes, materials, HDR,
                 BVH) and ``assemble`` into a torch ``SceneData``.
- ``ops``        Moller-Trumbore, the stackful BVH walk, and the CUDA
                 megakernel wrapper (``ops/mega.py``).
- ``integrator`` the plain torch NEE integrator (``wavefront``) and the
                 ``mega`` / ``scan`` engines.
- ``post``       ACES/Reinhard, gamma, BMP/PNG.
- ``cli``        ``python -m jaderaytracerendering_tpu_torch.cli.render``.
"""

__version__ = "0.1.0"
