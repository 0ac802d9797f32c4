"""Offline throughput: the samples (pixels x spp) of every image finished
in the window over the time from the window's start to the last image's
end, in millions a second (host clock; each image timed to its u8 array
on the host). The cells split it by the spread of their runs, each
with a bound of its own: ``render_msamples_s`` the megakernel at 1024^2,
``.tile`` at 256^2 (steadier: little host finish an image), ``.pool``
the pool engine (its host loop, one sync an iteration, spreads it
wider)."""


def read(run):
    w = run.window
    if not w.ends:
        return None
    return sum(w.samples) / w.seconds / 1e6
