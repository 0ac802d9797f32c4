"""The benchmark's plain reference: the path tracer written out again in
plain PyTorch and NumPy, so that the benchmark can decide ``correct``
without trusting the program.

It imports nothing of the program (neither the JAX package nor its
PyTorch port) and takes none of their tables: it builds its own from the
raw triangles of ``benchmark/scene.py`` and finds each ray's nearest
hit among all triangles (no BVH: the triangles of every cluster of 64
whose box the ray meets, ``scene.clusters``). Its draws are keyed by (pixel,
sample, bounce, site, seed) as the program's are, so it reproduces the
program's samples one by one, and a film sum differs from the program's
by rounding alone.

- ``rng``, ``vec``: the keyed counter RNG and plane-form vector helpers.
- ``scene``: the reference's tables from the raw scene.
- ``camera``, ``envmap``: orbit camera, primary rays, the sky lookup.
- ``pathtrace``: the full NEE integrator (PathTrace.cu's pathTracing).
- ``preview``: the 2-bounce preview integrator (fshader_preview.fsh).
- ``post``: the offline tone map (NumPy) and the preview's display.

Every float computation takes a ``dtype``: float32 as the configuration
states it, or a lower precision for the control (``benchmark/control.py``).
"""
