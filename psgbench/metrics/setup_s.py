"""Process start to the first timed image (host clock): imports, the
program built, the benchmark's weights made on the card and handed to it,
kernels built or loaded, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
