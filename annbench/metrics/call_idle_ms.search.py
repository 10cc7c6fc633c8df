"""``call_idle_ms.search``: device idle ms per call of the whole query set
while the host was inside ``search_device`` (the program's ``ivf.search``
span), apart from the caller's readback and loop, from the device stretch.
Each idle gap is split over the program's spans open on the host while it
lasts (``_spans.Spans.idle_us``)."""

from annbench.metrics._spans import CALLER, spans


def read(ctx):
    s = spans(ctx)
    if s is None:
        return None
    idle = s.idle_us(ctx.device)
    return sum(v for k, v in idle.items() if k != CALLER) / s.n_steps / 1e3
