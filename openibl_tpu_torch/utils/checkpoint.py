"""The JAX package's .npz checkpoints, read and written without jax.

openibl_tpu/utils/checkpoint.py stores one npz entry per pytree leaf, keyed
``leaf:<path>`` with "/"-joined dict keys, plus a JSON ``__meta__`` entry.
Two layouts occur: a bare model tree (``leaf:base/conv1_1/w``) and a
pipeline checkpoint (``leaf:params/base/conv1_1/w`` beside optimizer state).

``save_checkpoint`` writes the same format from a nested dict of numpy
arrays (or tensors), so the JAX package's ``load_checkpoint`` reads the
port's ``params`` subtree; what only the port resumes from (the torch SGD
momentum buffers) lives under keys of its own beside it.
"""

import json
import os
import os.path as osp
import shutil

import numpy as np

from openibl_tpu_torch.utils import to_numpy


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + "/")
        else:
            yield path, to_numpy(value)


def save_checkpoint(path, tree, metadata=None, is_best=False):
    """Write ``tree`` (nested dicts of arrays) + metadata as one .npz, and
    copy it to ``model_best.npz`` beside it when ``is_best``. The write
    goes to a temporary file renamed into place, so an abort mid-write
    never corrupts the previous checkpoint. Returns the path written."""
    d = osp.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays = {"leaf:" + p: leaf for p, leaf in _flatten(tree)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"metadata": metadata or {}}).encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    if is_best:
        best = osp.join(osp.dirname(path) or ".", "model_best.npz")
        shutil.copy(path, best + ".tmp")
        os.replace(best + ".tmp", best)
    return path


def read_checkpoint(path):
    """The whole checkpoint as (nested dict of numpy arrays, metadata)."""
    tree = {}
    with np.load(path, allow_pickle=False) as data:
        meta = {}
        if "__meta__" in data.files:
            meta = json.loads(bytes(data["__meta__"]).decode()).get(
                "metadata", {})
        for key in data.files:
            if not key.startswith("leaf:"):
                continue
            parts = key[len("leaf:"):].split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return tree, meta


def load_npz_tree(path):
    """Read a checkpoint's model parameters into a nested dict of numpy
    arrays.

    Returns (tree, metadata, is_pipeline): for a pipeline checkpoint the
    tree is its ``params`` subtree and is_pipeline is True."""
    tree, meta = read_checkpoint(path)
    is_pipeline = "params" in tree
    return (tree["params"] if is_pipeline else tree), meta, is_pipeline
