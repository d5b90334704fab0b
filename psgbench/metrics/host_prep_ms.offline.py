"""Milliseconds of the program's ``Preprocessor`` per image: a host-clock
span around each call, at set-up, where the traffic prepares its images."""


def read(ctx):
    ms = ctx.get("setup_prep_ms")
    return sum(ms) / len(ms) if ms else None
