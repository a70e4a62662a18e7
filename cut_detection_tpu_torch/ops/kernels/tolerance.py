"""How a block-kernel instance that rounds its activation to bf16 is held
against its plain version.

K1's instance (``conv1_block[bf16]``) and ``conv_block[bf16_out]`` round
``relu(acc + bias)`` to bf16 before the pool.  The kernel and its plain
version sum the f32 accumulator in different orders, and where the two
sums lie on two sides of a bf16 rounding boundary the pooled activation
``m`` lands one bf16 ulp apart.  Such an element, a *crossing*, may
differ by that ulp, at most ``2^-7 |m*s|`` in ``y = m*s + t``, plus one
ulp of ``y`` (``2^-7 |y|``) where the output is bf16 and so rounded once
more.  Every other element must agree within ``CROSSING_ATOL``, and
crossings must be rare: at most ``MAX_CROSSING_SHARE`` of the elements.

The share is what fails a wrong kernel.  One that leaves out the
activation's rounding, or rounds toward zero, stays within the one-ulp
bound on every element but misses on a quarter to a half of them
(``tests/test_torch_bf16_check.py`` shows both on the CPU).
"""

from __future__ import annotations

import torch

BF16_RTOL = 2.0 ** -7       # one bf16 ulp, relative, at most
CROSSING_ATOL = 1e-5        # elements further apart than this crossed
MAX_CROSSING_SHARE = 1e-3   # of the elements, at most


def bf16_check(got: torch.Tensor, want: torch.Tensor,
               offset: torch.Tensor) -> tuple[bool, float, int]:
    """``got`` (the kernel's output) against ``want`` (the plain
    version's, of the same shape and dtype) of a block whose BN offset is
    ``offset``.  Returns ``(ok, worst, crossings)``: ``worst`` is the
    largest error over its one-ulp bound (at most 1.001 passes),
    ``crossings`` the number of elements further apart than
    ``CROSSING_ATOL``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"got {got.dtype} {tuple(got.shape)}, want "
                         f"{want.dtype} {tuple(want.shape)}")
    bf16_out = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ulps = (want - offset).abs()
    if bf16_out:
        ulps = ulps + want.abs()
    worst = (err / (BF16_RTOL * ulps + CROSSING_ATOL)).max().item()
    crossings = int((err > CROSSING_ATOL).sum().item())
    ok = worst <= 1.001 and crossings <= MAX_CROSSING_SHARE * err.numel()
    return ok, worst, crossings
