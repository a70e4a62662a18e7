"""cut_detection_tpu_torch — the PyTorch + CUDA port of ``cut_detection_tpu``.

The JAX package stays the reference; this package mirrors its module
names so each piece has an obvious counterpart:

- ``ops.nn``             NHWC torch ops with the JAX package's numerics.
- ``ops.kernels``        hand-written CUDA kernels for Hopper (``csrc/``),
                         each beside its plain PyTorch version.
- ``models``             ``nn.Module`` blocks, nets and the glued classifier.
- ``segmentation``       host-side run-length table, orphan glue, CSV.
- ``pipeline``           decode -> classify -> segment -> CSV.
- ``cli.segment_video``  the ``segment_video`` command line.
- ``scripts``            measurement entry points (``bench_fused_conv1``).

The port imports nothing of ``cut_detection_tpu``: ``config``,
``checkpoint.io``, ``geometry``, ``native``, ``data``, ``utils`` and
``cli.evaluate`` are its own copies of the JAX package's jax-free modules,
and the bundled classifier is read from ``cut_detection_tpu/prod_net/``
by path.
"""

# Lazy re-exports (PEP 562): submodule imports run this file first, so it
# must stay dependency-free — torch loads only when a model or the
# pipeline is actually touched.
_LAZY = {
    "load_and_glue_nets": "cut_detection_tpu_torch.models.assembly",
    "load_default_net": "cut_detection_tpu_torch.models.assembly",
    "load_triplet_or_default": "cut_detection_tpu_torch.models.assembly",
    "classify_video": "cut_detection_tpu_torch.pipeline",
    "segment_video_file": "cut_detection_tpu_torch.pipeline",
    "Segmentation": "cut_detection_tpu_torch.segmentation.rle",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
