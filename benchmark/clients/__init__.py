"""Client loops: one module per kind of traffic, named by a traffic
file's ``client`` entry. Each holds a ``Client`` class with

- ``warm_up()``: every shape the window will use, once;
- ``window(seconds, seed)`` -> ``Window``: the measured loop;
- ``keep(window, seed)``: the outputs the comparison reads, moved to the
  host as ``window.kept["outputs"]`` ({item: {name: array}});
- ``reference(window, seed, dtype)``: the plain reference's outputs of
  the same items, in the same form;
- ``compare(outputs, refs)`` -> the compared numbers by name."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    """What one measured window did, on the host's clock."""

    t0: float                  # the window's start
    ends: list                 # each finished item's end (image or frame)
    starts: list               # each finished item's start
    samples: list              # samples each finished item rendered
    bound_s: float             # the roofline bound of the finished items, summed
    counters: dict             # the program's counters over the window
    kept: dict                 # the outputs kept for the comparison
    attempted: int = 0

    @property
    def t1(self) -> float:
        return self.ends[-1] if self.ends else self.t0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0
