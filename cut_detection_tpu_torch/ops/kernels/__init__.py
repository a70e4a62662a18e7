"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on CUDA (or raises); it never falls back
from one to the other.  ``launches`` on each wrapper counts kernel
launches only; ``launch_counts()`` reads every wrapper's.
"""


def launch_counts() -> dict[str, int]:
    """The kernel launches of every wrapper so far in this process, keyed
    ``name[instance]`` where the wrapper counts by instance (or stage)
    and ``name`` where it does not; take two readings and subtract."""
    from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block
    from cut_detection_tpu_torch.ops.kernels.conv1_stages import (
        conv1_stages,
    )
    from cut_detection_tpu_torch.ops.kernels.conv_block import conv_block
    from cut_detection_tpu_torch.ops.kernels.conv_block_i8 import (
        conv1_block_i8,
        conv_block_i8,
    )
    from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
        resize_normalize,
    )
    from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import (
        yuv420_to_bgr,
    )

    counts = {}
    for fn in (conv1_block, conv_block, conv1_block_i8, conv_block_i8,
               resize_normalize, yuv420_to_bgr, conv1_stages):
        by_instance = getattr(fn, "instance_launches", None)
        if by_instance is None:
            counts[fn.__name__] = fn.launches
        else:
            counts.update({f"{fn.__name__}[{inst}]": n
                           for inst, n in by_instance.items()})
    return counts
