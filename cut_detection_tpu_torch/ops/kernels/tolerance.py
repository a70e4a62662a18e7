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

XLA's numerics (the ``bf16_xla`` instances) round the accumulator
itself, so there a crossing moves the pooled activation by one ulp of the
accumulator, which the bias sum can make larger than one ulp of the
activation: ``xla_check`` holds them, by the same rule.

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


def _bar(got, want, ulps, crossings) -> tuple[bool, float, int]:
    """``(ok, worst, crossings)``: every element within its one-ulp bound
    ``BF16_RTOL * ulps + CROSSING_ATOL`` (``worst`` is the largest error
    over its bound, at most 1.001 passes), and ``crossings`` on at most
    ``MAX_CROSSING_SHARE`` of the elements."""
    worst = ((got - want).abs() / (BF16_RTOL * ulps + CROSSING_ATOL)).max()
    ok = worst.item() <= 1.001 and crossings <= MAX_CROSSING_SHARE * \
        got.numel()
    return ok, worst.item(), crossings


def _as_f32(got, want):
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"got {got.dtype} {tuple(got.shape)}, want "
                         f"{want.dtype} {tuple(want.shape)}")
    return got.dtype == torch.bfloat16, got.float(), want.float()


def bf16_check(got: torch.Tensor, want: torch.Tensor,
               offset: torch.Tensor) -> tuple[bool, float, int]:
    """``got`` (the kernel's output) against ``want`` (the plain
    version's, of the same shape and dtype) of a block whose BN offset is
    ``offset``.  Returns ``(ok, worst, crossings)``: ``worst`` is the
    largest error over its one-ulp bound (at most 1.001 passes),
    ``crossings`` the number of elements further apart than
    ``CROSSING_ATOL``."""
    bf16_out, got, want = _as_f32(got, want)
    ulps = (want - offset).abs()
    if bf16_out:
        ulps = ulps + want.abs()
    crossings = int(((got - want).abs() > CROSSING_ATOL).sum().item())
    return _bar(got, want, ulps, crossings)


def xla_check(got: torch.Tensor, want: torch.Tensor, offset: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor
              ) -> tuple[bool, float, int]:
    """The same bar for XLA's numerics (the ``bf16_xla`` instances):
    ``a = bf16(acc)``, ``z = bf16(a + bf16(bias))``, ``m`` the pool of
    ``relu(z)``, ``p = bf16(m * bf16(s))``, ``y = p + bf16(t)`` (rounded
    to bf16 for a bf16 output).  There a crossing is at the accumulator:
    ``a`` moves by one ulp, at most ``2^-7 |a|`` with ``|a| <= |z| +
    |bias|``, and the roundings of ``z`` and ``p`` add one ulp each, so
    ``p`` moves by at most ``2^-7 (3 |p| + |s * bias|)`` to first order;
    the bar takes ``2^-7 (4 |p| + 2 |s * bias|)``, plus one ulp of ``y``
    where the output is bf16.  Everything after the accumulator is the
    same arithmetic in the kernel and the plain version, so any element
    that differs at all crossed: those count against the 0.1% cap."""
    bf16_out, got, want = _as_f32(got, want)
    round_ = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    ulps = 4 * (want - round_(offset)).abs() + \
        2 * (round_(scale) * round_(bias)).abs()
    if bf16_out:
        ulps = ulps + want.abs()
    return _bar(got, want, ulps, int((got != want).sum().item()))
