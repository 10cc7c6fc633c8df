"""``call_ms.search``: host ms of the median ``search_device`` call of the
whole query set over the window's untraced calls, from the call to its
labels on the host. ``qps`` is the window's calls over its length, so a
few slow calls (the host's stalls) move it; their median is the steadier
reading of the same path."""

import statistics


def read(ctx):
    calls = ctx.host.get("call_s")
    if not calls:
        return None
    return statistics.median(calls) * 1e3
