"""The program's scene build: ``scene.scene.assemble`` with its default
BVH builder (``accel.native``), the tables' upload included (host clock,
synchronised)."""


def read(run):
    return run.scene_build_s
