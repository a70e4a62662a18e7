"""Training FLOPs (three forward passes' worth of every view) of every
frame stepped in the traced slice of the window over the slice times the
peak of the configuration's precision, in percent."""

from cutbench.harness.counts import train_flops_per_item


def read(ctx):
    tr = ctx["out"]["trace"]
    if tr is None or tr["handoffs"] == 0:
        return None
    traffic = ctx["traffic"]
    flops = (train_flops_per_item(ctx["config"], traffic)
             * traffic["batch"] * tr["handoffs"])
    peak = ctx["config"]["peaks"][traffic["precision"]]
    return 100.0 * flops / (tr["window_s"] * peak)
