"""The least time of the classify step's work at the cell's shapes
(``harness.counts.classify_step_least_s``), over the kernels' device time
a batch in the traced slice, in percent."""

from cutbench.harness.counts import classify_step_least_s


def read(ctx):
    tr = ctx["out"]["trace"]
    if tr is None or tr["handoffs"] == 0 or tr["kernel_s"] <= 0:
        return None
    least = classify_step_least_s(ctx["config"], ctx["traffic"])
    return 100.0 * least * tr["handoffs"] / tr["kernel_s"]
