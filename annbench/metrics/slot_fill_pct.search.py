"""``slot_fill_pct.search``: the share of the scan's padded lanes that hold
a code the scan keeps, 100 x ``scan.kept`` / ``scan.lanes`` of the
program's counters over the traced calls (for grouping, ``scan.kept`` counts
the unpruned subgroups' rows of the scheduled groups)."""

from annbench.metrics._spans import counters


def read(ctx):
    c = counters()
    if not c or not c.get("scan.lanes"):
        return None
    return 100.0 * c["scan.kept"] / c["scan.lanes"]
