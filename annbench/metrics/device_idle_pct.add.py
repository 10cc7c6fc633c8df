"""``device_idle_pct.add``: % of the device stretch's window (its first
step's start to the end of its last step's device work; seconds long,
traced without the Python stack) in which no device operation ran."""

from annbench.metrics._layer import idle_pct


def read(ctx):
    return idle_pct(ctx)
