"""``dispatch_ms.search``: host ms per ``search_device`` call of the whole
query set, from call to return (the enqueue of every chunk, before the
answer is read back), averaged over the window's untraced calls."""


def read(ctx):
    h = ctx.host
    if not h.get("n_dispatch"):
        return None
    return h["dispatch_s"] / h["n_dispatch"] * 1e3
