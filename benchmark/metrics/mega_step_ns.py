"""The megakernel's launch time per path step, in ns: 1000 x the
program's counter ``ops.mega.launch_us`` over the steps its paths took,
``ops.mega.bounces`` + ``ops.mega.march_steps`` (each launch's
%globaltimer stamps and its warps' counts, read after the image's sync
while the recorder is on; ``benchmark/spans.py``). A step is a bounce
(its branch, its light, sky and continuation walks and its shading) or
one trace of a direct refraction march inside the object (one walk), so
the reading falls when a step gets cheaper and stays where a change only
lengthens or shortens the paths or the marches.
``mega_step_ns.refract`` on the refracting statue. A program without the
march counter reads as nothing."""

from benchmark import spans


def read(run):
    launch = spans.counter(run, "ops.mega.launch_us")
    bounces, steps = spans.counter(run, "ops.mega.bounces"), spans.counter(run, "ops.mega.march_steps")
    if launch is None or bounces is None or steps is None or bounces + steps <= 0:
        return None
    return 1000.0 * launch / (bounces + steps)
