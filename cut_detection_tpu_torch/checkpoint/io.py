"""The native checkpoint format: a flat ``.npz`` of arrays keyed by tree
path.

Copy of ``cut_detection_tpu/checkpoint/io.py:22-82`` (``flatten_tree``,
``unflatten_tree``, ``save_bundle``, ``load_bundle``).  Paths are joined with
'/'; list indices are decimal segments; an empty dict or list leaf is a
``__empty__`` / ``__empty_list__`` marker, so round trips are exact.
"""

from __future__ import annotations

import numpy as np

_EMPTY = "__empty__"
_EMPTY_LIST = "__empty_list__"


def flatten_tree(tree, prefix=""):
    """Flatten a nest of dict/list/tuple into {path: np.ndarray}."""
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix + _EMPTY] = np.zeros((), dtype=np.int8)
            return out
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            # An empty list must survive the round trip too, or the
            # reloaded tree silently loses the node (KeyError later).
            out[prefix + _EMPTY_LIST] = np.zeros((), dtype=np.int8)
            return out
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


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


def save_bundle(path: str, tree) -> None:
    """Save a tree of numpy arrays to ``.npz``."""
    np.savez(path, **flatten_tree(tree))


def load_bundle(path: str):
    """Load a bundle saved by ``save_bundle`` (either package's)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat)
