"""``dispatch_ms.search``: host ms per ``search_device`` call of the whole
query set, from call to return (the enqueue of every chunk, before the
answer is read back), averaged over the window's untraced calls."""


def read(ctx):
    h = ctx.host
    if not h.get("call_s"):
        return None
    return h["dispatch_s"] / len(h["call_s"]) * 1e3
