"""Package setup (reference: setup.py — distutils package ``frameID``).

``pip install -e .`` exposes ``cut_detection_tpu`` plus the
``segment-video`` / ``split-video`` console entry points.
"""

import os

from setuptools import find_packages, setup


def _version() -> str:
    # Single source of truth: cut_detection_tpu/version.py (no import, so
    # setup works without the package's runtime deps installed).
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cut_detection_tpu", "version.py")
    with open(path) as f:
        for line in f:
            if line.startswith("__version__"):
                return line.split("=")[1].strip().strip('"')
    raise RuntimeError("__version__ not found in cut_detection_tpu/version.py")


setup(
    name="cut_detection_tpu",
    version=_version(),
    description=(
        "TPU-native NFL broadcast cut detection: JAX/XLA/Pallas frame "
        "classifier + run-length segmenter"
    ),
    packages=find_packages(include=["cut_detection_tpu", "cut_detection_tpu.*",
                                    "cut_detection_tpu_torch",
                                    "cut_detection_tpu_torch.*"]),
    package_data={"cut_detection_tpu": ["prod_net/*.npz", "prod_net/*.json"],
                  "cut_detection_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    # Pinned like the reference (requirements.txt:1-4 pins torch===1.9.1
    # etc.).  opencv is pinned EXACTLY: the bit-exact INTER_LINEAR resize
    # parity (docs/PARITY.md) was verified against this build's SIMD
    # rounding; a cv2 upgrade must re-run tests/test_resize.py before the
    # pin moves.  jax moves in lockstep with jaxlib, so a compatible range.
    install_requires=[
        "jax>=0.9.0,<0.10",
        "numpy>=2.0,<3",
        # Headless variant: same cv2 code (the bit-exact resize surface,
        # docs/PARITY.md) minus GUI deps, and it matches what the
        # Dockerfile and CI install — pinning the GUI build here would
        # make pip install a second conflicting cv2 distribution there.
        "opencv-python-headless==5.0.0.93",
    ],
    extras_require={
        "train": ["optax>=0.2.6,<0.3", "orbax-checkpoint>=0.11"],
        "serve": [],  # stdlib http.server — no extra deps
        "flax": ["flax>=0.10"],  # linen mirrors + export --format flax
        "label-ui": ["streamlit>=1.30"],
        "dev": ["pytest>=8", "torch"],
    },
    entry_points={
        "console_scripts": [
            "segment-video=cut_detection_tpu.cli.segment_video:main",
            "segment-videos=cut_detection_tpu.cli.segment_videos:main",
            "split-video=cut_detection_tpu.cli.split_video:main",
            "cutdet-train=cut_detection_tpu.cli.train_supervised:main",
            "cutdet-pretrain=cut_detection_tpu.cli.train_contrastive:main",
            "cutdet-embed=cut_detection_tpu.cli.embed_frames:main",
            "cutdet-evaluate=cut_detection_tpu.cli.evaluate:main",
            "cutdet-export=cut_detection_tpu.cli.export_model:main",
            "cutdet-serve=cut_detection_tpu.cli.serve:main",
            "cutdet-label=cut_detection_tpu.cli.labelling:main",
            "cutdet-bench=cut_detection_tpu.cli.bench_pipeline:main",
            "cutdet-doctor=cut_detection_tpu.cli.doctor:main",
        ]
    },
)
