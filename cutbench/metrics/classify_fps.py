"""Frames scored in the window over the window's wall time, the window
ended by the loop's final fetch of the scores."""


def read(ctx):
    out = ctx["out"]
    return out["items"] / out["window_s"]
