"""Model FLOPs of every frame handed off in the traced slice of the
window over the slice times the peak of the configuration's rung, in
percent."""

from cutbench.harness.counts import forward_flops


def read(ctx):
    tr = ctx["out"]["trace"]
    if tr is None or tr["handoffs"] == 0:
        return None
    traffic = ctx["traffic"]
    flops = forward_flops(ctx["config"]["model"], traffic["height"],
                          traffic["width"]) * traffic["batch"] * tr["handoffs"]
    peak = ctx["config"]["peaks"][traffic["precision"]]
    return 100.0 * flops / (tr["window_s"] * peak)
