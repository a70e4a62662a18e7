"""Frame datasets over extracted JPEG trees.

Copy of ``cut_detection_tpu/data/frames.py`` (it imports no jax).
Reference: frameID/data.py:34-181.  Both datasets recursively glob image
files under a directory and load them as float32 RGB in [0, 1].

Deliberate fix vs the reference: the reference's ``_parse_path`` keeps
``os.walk`` order **unsorted** (frameID/data.py:67-78), so the index ->
frame-number correspondence its label CSVs rely on is filesystem-dependent.
Here the file list is sorted; ``frame_%07d.jpg`` naming (split_video.py:53)
makes lexicographic order equal frame order.

Items are loaded as **uint8 RGB HWC** and normalized on the device;
augmentation for contrastive training also runs there
(``train/augment.py``) rather than in dataset workers.
"""

from __future__ import annotations

import csv
import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# frameID/data.py:37-47 / 103-113
IMG_EXT = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
           ".tiff", ".webp")

# frameID/data.py:116
LAB_ENUM = {"a22": 0, "ez": 1, "b": 2}


def _parse_path(path: str, ext: str) -> list[str]:
    """Recursive glob of ``ext`` files, sorted (see module docstring)."""
    out = []
    for root, _, files in os.walk(path):
        for fl in files:
            full = os.path.join(root, fl)
            if ext in full[-5:]:  # same suffix test as data.py:76
                out.append(full)
    out.sort()
    return out


def _read_image_rgb_u8(path: str) -> np.ndarray:
    """Load an image as uint8 RGB HWC.

    Equivalent to torchvision ``read_image(..., UNCHANGED)`` for RGB JPEGs
    (frameID/data.py:83,173) modulo layout (HWC here vs CHW there).
    """
    if cv2 is None:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"Failed to read image: {path}")
    return img[..., ::-1]  # BGR -> RGB


class ContrastiveFrameDataset:
    """Unlabeled frames for contrastive pretraining (frameID/data.py:34-97).

    ``__getitem__`` returns ``{"x": uint8 RGB HWC}``.  The reference applies
    its torchvision transform pipeline twice per item in host workers
    (data.py:86-93); here the two augmented views are generated **on
    device** by the training loop (train/augment.py) — pass ``trs`` only if
    you want a host-side callable applied for API compatibility.
    """

    def __init__(self, path: str, trs=None, ext: str = ".jpg",
                 size: int | None = None):
        if ext not in IMG_EXT:
            raise ValueError(f"{ext} is not a valid image file extension.")
        self.path = path
        self.ext = ext
        self.trs = trs
        self.file_list = _parse_path(path, ext)
        if size is not None:
            self.file_list = self.file_list[: min(size, len(self.file_list))]

    def __getitem__(self, idx: int) -> dict:
        x = _read_image_rgb_u8(self.file_list[idx])
        if self.trs is not None:
            xf = x.astype(np.float32) / 255.0
            return {"x": xf, "x_t1": self.trs(xf), "x_t2": self.trs(xf)}
        return {"x": x}

    def __len__(self) -> int:
        return len(self.file_list)


class SupervisedFrameDataset:
    """Labeled frames for classification (frameID/data.py:100-181).

    Labels come from a CSV of ``(start_frame, label)`` range boundaries; the
    label of frame ``i`` is the label of the last row whose start_frame is
    <= i, found via searchsorted right minus one (data.py:162-166).

    ``__getitem__`` returns ``{"x": uint8 RGB HWC, "y": int64}``; normalize
    on device with ``ops.preprocess.normalize_frames`` (note frames on disk
    are already RGB so only the /255 applies).
    """

    lab_enum = LAB_ENUM

    def __init__(self, path: str, labs_file: str, ext: str = ".jpg",
                 size: int | None = None):
        if ext not in IMG_EXT:
            raise ValueError(f"{ext} is not a valid image file extension.")
        self.path = path
        self.ext = ext
        with open(os.path.join(path, labs_file), "r") as f:
            rows = [(int(r[0]), r[1]) for r in csv.reader(f, delimiter=",")]
        self.label_starts = np.asarray([r[0] for r in rows], dtype=np.int32)
        self.label_values = np.asarray([self.lab_enum[r[1]] for r in rows],
                                       dtype=np.int32)
        self.file_list = _parse_path(path, ext)
        if size is not None:
            self.file_list = self.file_list[: min(size, len(self.file_list))]

    def _get_label(self, idx: int) -> int:
        pos = int(np.searchsorted(self.label_starts, idx, side="right"))
        return int(self.label_values[pos - 1])

    def __getitem__(self, idx: int) -> dict:
        return {
            "x": _read_image_rgb_u8(self.file_list[idx]),
            "y": np.int64(self._get_label(idx)),
        }

    def __len__(self) -> int:
        return len(self.file_list)


class ConcatDataset:
    """Minimal torch-free ConcatDataset (supervised_training.py:68 analog)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[ds][idx - int(self.offsets[ds])]

    def __len__(self) -> int:
        return int(self.offsets[-1])
