"""jaderaytracerendering_tpu_torch — the path tracer on PyTorch and CUDA.

The port of ``jaderaytracerendering_tpu`` (JAX/Pallas) to PyTorch, with
the kernels written by hand in CUDA C++ for Hopper (``csrc/``). Module
paths mirror the JAX package's, so each file has one counterpart there.
The JAX package is the reference; this package never imports ``jax``.

- ``core``       counter RNG (and the reference's GLSL hash), plane-form
                 vector math, camera, film.
- ``scene``      host-side NumPy scene building (meshes, OBJ I/O,
                 materials, HDR, the native or NumPy SAH BVH) and
                 ``assemble`` into a torch ``SceneData``.
- ``accel``      the SAH BVH builders (NumPy, and the native one built
                 with g++ from ``runtime/``).
- ``ops``        the kernel wrappers and their plain versions: the
                 megakernel and the preview kernel (``mega.py``), the
                 pool's spawn, trace, front and resolve kernels, postfx;
                 the CUDA library's build (``build.py``, ``kernels.py``);
                 Moller-Trumbore and the shadow test, the BVH walk.
- ``integrator`` the plain torch NEE integrator (``wavefront``), the
                 preview integrator, and the engines ``mega``, ``pool``
                 and ``scan`` (``render.render_film``), each also over a
                 pixel window.
- ``parallel``   multi-device rendering over ``torch.distributed``: film
                 tiles x samples on a mesh of ranks (``sharding``).
- ``post``       ACES/Reinhard, gamma, BMP/PNG.
- ``utils``      ``RenderConfig`` and its parity presets; stage logging,
                 ray counters, profiler capture.
- ``cli``        ``python -m jaderaytracerendering_tpu_torch.cli.render``
                 (``--mesh TILExSPP`` over ranks), ``cli.preview``, and
                 the measurement tools ``cli.pool_sweep``, ``cli.film_ab``.
- ``entry``      ``entry()`` and ``dryrun_multichip(n)``.
"""

__version__ = "0.1.0"
