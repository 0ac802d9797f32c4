"""The share of the traced window in which the device ran no kernel, copy
or fill (torch.profiler; ``benchmark/profiling.py``), in %. The cells
name it by the end-to-end metric it moves: ``device_idle_pct.mega``,
``.tile`` and ``.pool`` while the offline client renders whole images
(1024^2 and 256^2 through the megakernel, 1024^2 through the pool),
``.preview`` while the preview client renders frames."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
