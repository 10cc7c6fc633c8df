"""``finalize_s.add``: host seconds of the window's closing ``finalize``
(``models/storage.py::PostingListBuilder.finalize``: the host builder's
concatenation, the stable sort on the card, the copies back)."""


def read(ctx):
    return ctx.host.get("finalize_s")
