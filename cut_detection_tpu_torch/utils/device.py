"""Device selection (counterpart of ``cut_detection_tpu/utils/platform.py``).

The port never falls back to the CPU on its own: the CPU runs only when
the caller asks for it (``--cpu``), and a missing CUDA device is an error.
"""

from __future__ import annotations

import subprocess
import threading

import torch


def resolve_device(cpu: bool = False) -> torch.device:
    """``cpu`` when asked for, else the CUDA device; raise when there is none."""
    if cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError("no CUDA device is available; pass --cpu to run on "
                       "the CPU")


def strict_fp32() -> None:
    """Keep float32 matmuls and cuDNN convolutions out of TF32.

    cuDNN convolutions run float32 in TF32 by default, which keeps about
    three decimal digits — far outside the 1e-4 logit parity bar.  The
    JAX package asks for ``Precision.HIGHEST`` per op for the same reason
    (``cut_detection_tpu/ops/nn.py``); PyTorch only has process-wide
    switches, so entry points call this once.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def card_info() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bounded_call(fn, timeout: float, what: str):
    """``fn()`` on a daemon thread, bounded in wall-clock time.

    Counterpart of ``cut_detection_tpu/utils/platform.py:bounded_call``.
    Returns ``fn()``'s value and re-raises its exception; raises
    ``TimeoutError("<what> did not complete within <t> s")`` when the
    call outlives ``timeout`` seconds.  A hung CUDA call (a card that
    stopped answering) cannot be interrupted, so the abandoned thread is
    left to the process's exit; the caller gets a failure it can report.
    """
    out: list = []
    err: list = []

    def work():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    t = threading.Thread(target=work, daemon=True, name=f"bounded-{what}")
    t.start()
    t.join(timeout)
    if err:
        raise err[0]
    if not out:
        raise TimeoutError(f"{what} did not complete within {timeout:g} s")
    return out[0]
