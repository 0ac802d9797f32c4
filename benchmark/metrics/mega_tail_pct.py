"""The megakernel's tail: the share of its launches' time after the first
handout that found the work counter dry, when only lanes still on their
last item run, in %: 100 x the program's counter ``ops.mega.tail_us``
over ``ops.mega.launch_us`` (each launch's %globaltimer stamps, read
after the image's sync while the recorder is on; ``benchmark/spans.py``).
``mega_tail_pct`` at 1024^2, ``.tile`` at 256^2. A program without the
stamps reads as nothing."""

from benchmark import spans


def read(run):
    tail, launch = spans.counter(run, "ops.mega.tail_us"), spans.counter(run, "ops.mega.launch_us")
    if tail is None or not launch:
        return None
    return 100.0 * tail / launch
