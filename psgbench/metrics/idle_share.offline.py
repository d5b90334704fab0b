"""Percent of the profiled phase in which no operation ran on the card
(kernels, copies and sets merged)."""


def read(ctx):
    ph = ctx["phases"].get("profiled")
    if not ph or "trace" not in ph or ph["trace"].window_s <= 0:
        return None
    tr = ph["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
