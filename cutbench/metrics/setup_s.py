"""Seconds from the process's start to the first timed batch: imports,
the seeded frames and weights, the program's build and warm-up."""


def read(ctx):
    return ctx["setup_s"]
