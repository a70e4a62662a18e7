"""Training frames stepped in the window (originals, not views) over the
window's wall time, the window ended by a synchronize."""


def read(ctx):
    out = ctx["out"]
    return out["items"] / out["window_s"]
