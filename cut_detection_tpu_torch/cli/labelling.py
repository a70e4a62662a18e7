"""``labelling``: label random frames by hand into ``labels.json``.

Copy of ``cut_detection_tpu/cli/labelling.py`` (``:24-145``; reference
training_scripts/labelling.py) over the port's
``data.frames.ContrastiveFrameDataset``.  It shows a random frame and
records a label into ``labels.json`` in the data directory, in the
reference's storage format (labelling.py:29-36; a different format from
the ``frames.csv`` range files the supervised dataset reads, a mismatch
inherited from the reference).  The streamlit app runs where streamlit
is installed (imported only then); elsewhere a terminal app labels frames
interactively over a coarse ANSI preview.  It runs on the host only, so
it has no ``--cpu``.

    python -m cut_detection_tpu_torch.cli.labelling [DATA_DIR] \
        [--terminal] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

LABELS = {"e": "EZ", "a": "A22", "b": "B"}  # labelling.py:52-59 vocabulary


def get_labels(directory: str) -> dict:
    path = os.path.join(directory, "labels.json")
    if not os.path.isfile(path):
        return {}
    with open(path, "r") as f:
        return json.load(f)


def write_label(directory: str, labels: dict, idx: int, lab: str) -> dict:
    labels[str(idx)] = lab
    with open(os.path.join(directory, "labels.json"), "w") as f:
        json.dump(labels, f)
    return labels


def _require_frames(ds, data_dir: str) -> None:
    if len(ds) == 0:
        raise SystemExit(
            f"no frames found under {data_dir!r} — point the tool at a "
            "directory of frame_*.jpg files (cutdet split-video writes "
            "them)")


def _streamlit_app(data_dir: str) -> None:
    import streamlit as st

    from cut_detection_tpu_torch.data.frames import ContrastiveFrameDataset

    ds = ContrastiveFrameDataset(data_dir, ext=".jpg")
    _require_frames(ds, data_dir)
    labels = get_labels(data_dir)
    # The displayed frame index must SURVIVE the rerun a button click
    # triggers — a fresh random index each run would record the label
    # against a frame the user never saw.  (The reference has exactly
    # that statefulness bug, labelling.py:42-61; a label written to a
    # random unseen frame corrupts training data, so fixed, not
    # replicated.)  A new frame is drawn only after a label lands.
    if "cutdet_idx" not in st.session_state:
        st.session_state.cutdet_idx = int(
            np.random.default_rng().integers(len(ds)))
    idx = st.session_state.cutdet_idx

    def _record(lab: str) -> None:
        write_label(data_dir, get_labels(data_dir), idx, lab)
        st.session_state.cutdet_idx = int(
            np.random.default_rng().integers(len(ds)))

    st.markdown(f"*Previous label: {labels.get(str(idx), 'None')}*")
    st.image(ds[idx]["x"], width=240)
    if st.button("Endzone"):
        _record("EZ")
    if st.button("All-22"):
        _record("A22")
    if st.button("Blank"):
        _record("B")
    st.markdown(f"**Labels: {len(get_labels(data_dir))}**")


def _ansi_preview(img: np.ndarray, width: int = 64) -> str:
    """Coarse terminal rendering using 24-bit background blocks."""
    h, w = img.shape[:2]
    aspect = h / w
    cols = width
    rows = max(1, int(cols * aspect / 2))
    ys = (np.linspace(0, h - 1, rows)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    lines = []
    for y in ys:
        line = []
        for x in xs:
            r, g, b = img[y, x][:3]
            line.append(f"\x1b[48;2;{r};{g};{b}m ")
        lines.append("".join(line) + "\x1b[0m")
    return "\n".join(lines)


def _terminal_app(data_dir: str, seed: int | None = None) -> None:
    from cut_detection_tpu_torch.data.frames import ContrastiveFrameDataset

    ds = ContrastiveFrameDataset(data_dir, ext=".jpg")
    _require_frames(ds, data_dir)
    labels = get_labels(data_dir)
    rng = np.random.default_rng(seed)
    print(f"{len(ds)} frames; {len(labels)} labeled. "
          "Keys: [e]ndzone [a]ll-22 [b]lank [s]kip [q]uit")
    while True:
        idx = int(rng.integers(len(ds)))
        img = ds[idx]["x"]
        print(_ansi_preview(img))
        print(f"frame {idx} (previous: {labels.get(str(idx), 'None')}) > ",
              end="", flush=True)
        try:
            choice = input().strip().lower()
        except EOFError:
            break
        if choice == "q":
            break
        if choice in LABELS:
            labels = write_label(data_dir, labels, idx, LABELS[choice])
            print(f"labeled {idx} = {LABELS[choice]} ({len(labels)} total)")


def main(args=None) -> None:
    p = argparse.ArgumentParser("Label random frames.")
    p.add_argument("data_dir", type=str, nargs="?", default="data/ravens-lions")
    p.add_argument("--terminal", action="store_true",
                   help="Force the terminal UI.")
    p.add_argument("--seed", type=int, default=None,
                   help="Seed the random frame order (terminal UI) for "
                        "reproducible/scripted labelling sessions.")
    ns = p.parse_args(args)
    if not ns.terminal:
        try:
            _streamlit_app(ns.data_dir)
            return
        except ImportError:
            print("streamlit not available; falling back to terminal UI.")
    _terminal_app(ns.data_dir, seed=ns.seed)


if __name__ == "__main__":
    main()
