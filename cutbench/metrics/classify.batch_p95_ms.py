"""The 95th percentile of the gaps between the harness's hand-offs of
consecutive batches to the loop, over every batch of the window."""

import statistics


def read(ctx):
    times = ctx["out"]["ticks"]
    if len(times) < 21:
        return None
    gaps = [b - a for a, b in zip(times, times[1:])]
    return statistics.quantiles(gaps, n=20)[18] * 1e3
