"""``evaluate``: a segments CSV against a truth CSV — frame accuracy,
per-class accuracy and boundary precision and recall at a frame
tolerance.  The JAX package's tool (``cut_detection_tpu/cli/evaluate.py``)
is plain numpy and imports no jax, so the port runs it as it is; this
module gives it the port's name, as the eval-corpus gates use it.

    python -m cut_detection_tpu_torch.cli.evaluate PRED.csv TRUTH.csv \\
        [--num-frames N] [--tolerance 30]
"""

from cut_detection_tpu.cli.evaluate import evaluate, main

__all__ = ["evaluate", "main"]

if __name__ == "__main__":
    main()
