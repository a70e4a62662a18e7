"""The native checkpoint format's reader: a flat ``.npz`` of arrays keyed
by tree path.

Copy of ``load_bundle`` and its ``unflatten_tree`` from
``cut_detection_tpu/checkpoint/io.py:44-82``.  Paths are joined with
'/'; list indices are decimal segments; an empty dict or list leaf is a
``__empty__`` / ``__empty_list__`` marker, so round trips are exact.
"""

from __future__ import annotations

import numpy as np

_EMPTY = "__empty__"
_EMPTY_LIST = "__empty_list__"


def unflatten_tree(flat: dict):
    """``{path: array}`` -> a nest of dicts and lists.  Integer-keyed
    levels become lists."""
    root: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        leaf = parts[-1]
        if leaf == _EMPTY:
            continue  # marker: the parent dict exists but is empty
        if leaf == _EMPTY_LIST:
            node[_EMPTY_LIST] = True
            continue
        node[leaf] = value

    def normalize(node):
        if not isinstance(node, dict):
            return node
        if _EMPTY_LIST in node:
            return []
        if node and all(k.isdigit() for k in node):
            return [normalize(node[str(i)]) for i in range(len(node))]
        return {k: normalize(v) for k, v in node.items()}

    return normalize(root)


def load_bundle(path: str):
    """Load a bundle saved as ``.npz`` by the JAX package's
    ``save_bundle``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat)
