"""A kernel's share of its roofline, named ``<kernel>_roofline`` by the
kernels the cell's client drives, with a ``.suffix`` where cells that
report different end-to-end metrics share the kernels (``mega``:
csrc/mega.cu, ``mega_roofline.tile`` at 256^2; ``pool``: the
four kernels of csrc/pool.cu; ``preview``: csrc/preview.cu and
csrc/postfx.cu; each with the small torch kernels of the film around
them): the least time the H100 could take for the window's items
(``roofline.bound_s`` of each item's samples x the traffic's
``ops_per_sample``, a preview frame's pixels x ``ops_per_pixel`` for its
display, and the scene's and film's bytes) over the device kernels' time
in the traced window (copies and fills left out), in %."""


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * run.window.bound_s / run.trace.kernel_s
