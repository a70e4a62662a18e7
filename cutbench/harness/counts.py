"""Operations and bytes of the model's work, counted from the shapes.

These counts are the yardstick's, not the program's: whatever
implements a step, the work it must do is the same.

- FLOPs count two per multiply-add of the 3x3 'same' convolutions and of
  the FC layers (pooling, activations and BN are not counted).
- A classify step reads its uint8 frames and the parameters once and
  writes one (conf, pred) pair a frame; its least time on the card is the
  larger of its operations over the peak of the configuration's rung and
  its bytes over the memory bandwidth.
"""

from __future__ import annotations

from cutbench.reference.model import POOL, layer_widths


def forward_flops(model: dict, h: int, w: int) -> int:
    """FLOPs of one frame's forward pass at ``h`` x ``w``."""
    convs, fcs = layer_widths(model)
    total = 0
    for cin, cout in convs:
        total += 2 * h * w * cin * cout * 9
        h, w = h // POOL, w // POOL
    for fin, fout in fcs:
        total += 2 * fin * fout
    return total


def param_count(model: dict) -> int:
    """Weights, biases and the four BN vectors of every normalised layer."""
    convs, fcs = layer_widths(model)
    n = sum(cout * cin * 9 + cout + 4 * cout for cin, cout in convs)
    n += sum(fout * fin + fout for fin, fout in fcs)
    n += sum(4 * fout for _, fout in fcs[:-1])
    return n


def classify_step_bytes(model: dict, batch: int, h: int, w: int) -> int:
    """uint8 frames and float32 parameters read, float32 conf and int32
    pred written."""
    return batch * h * w * 3 + 4 * param_count(model) + batch * 8


def classify_step_least_s(config: dict, traffic: dict) -> float:
    """The least time of one classify step on the card."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    model, peaks = config["model"], config["peaks"]
    ops = b * forward_flops(model, h, w)
    return max(ops / peaks[traffic["precision"]],
               classify_step_bytes(model, b, h, w) / peaks["hbm_bytes_per_s"])


def train_flops_per_item(config: dict, traffic: dict) -> int:
    """Training FLOPs of one item stepped: three forward passes' worth
    (forward, and the backward's two products) of every view made of
    it."""
    views = traffic.get("views", 1)
    vh, vw = traffic.get("view_height", traffic["height"]), traffic.get(
        "view_width", traffic["width"])
    return 3 * views * forward_flops(config["model"], vh, vw)
