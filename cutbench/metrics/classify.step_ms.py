"""Device time of every kernel in the traced slice of the window, per
batch handed off in it."""


def read(ctx):
    tr = ctx["out"]["trace"]
    if tr is None or tr["handoffs"] == 0 or tr["kernel_s"] <= 0:
        return None
    return tr["kernel_s"] / tr["handoffs"] * 1e3
