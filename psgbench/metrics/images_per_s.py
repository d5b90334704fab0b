"""Images completed in the window over the window's seconds (host clock)."""


def read(ctx):
    ph = ctx["phases"].get("timed")
    return ph["images"] / ph["seconds"] if ph and ph["images"] else None
