"""The megakernel's launch time per bounce it resolved, in ns: 1000 x the
program's counter ``ops.mega.launch_us`` over ``ops.mega.bounces`` (each
launch's %globaltimer stamps and its warps' bounce counts, read after the
image's sync while the recorder is on; ``benchmark/spans.py``). A bounce
is one vertex of a path: its branch, its light, sky and continuation
walks and its shading, so the reading falls when a bounce gets cheaper
and stays where a change only shortens or lengthens the paths.
``mega_bounce_ns.closeup`` at the close-up. A program without the
counters reads as nothing."""

from benchmark import spans


def read(run):
    launch, bounces = spans.counter(run, "ops.mega.launch_us"), spans.counter(run, "ops.mega.bounces")
    if launch is None or not bounces:
        return None
    return 1000.0 * launch / bounces
