"""The share of the traced slice of the window in which no device event
ran."""


def read(ctx):
    tr = ctx["out"]["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
