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


def load_checkpoint(path, target_tree, strict=False, verbose=False):
    """Read ``path`` into the structure of ``target_tree`` (nested dicts of
    arrays), the JAX package's tolerant load: a leaf absent from the file,
    or stored with another shape, keeps the target's value (with
    ``strict``, it raises). Returns (tree, metadata)."""
    stored, meta = read_checkpoint(path)

    def merge(target, source, key):
        if isinstance(target, dict):
            return {k: merge(v, source.get(k) if isinstance(source, dict)
                             else None, f"{key}/{k}" if key else k)
                    for k, v in target.items()}
        if source is None or isinstance(source, dict):
            if strict:
                raise KeyError(f"missing leaf:{key} in {path}")
            if verbose:
                print(f"missing leaf:{key}, keeping target")
            return target
        if tuple(np.shape(target)) != source.shape:
            if strict:
                raise ValueError(f"shape mismatch at leaf:{key}: "
                                 f"{source.shape} vs {np.shape(target)}")
            if verbose:
                print(f"mismatch at leaf:{key}, keeping target")
            return target
        return source

    return merge(target_tree, stored, ""), meta


def load_metadata(path):
    """A checkpoint's metadata alone."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(bytes(data["__meta__"]).decode()).get(
            "metadata", {})


def load_npz_tree(path):
    """Read a checkpoint's model parameters into a nested dict of numpy
    arrays.

    Returns (tree, metadata, is_pipeline): for a pipeline checkpoint the
    tree is its ``params`` subtree and is_pipeline is True."""
    tree, meta = read_checkpoint(path)
    is_pipeline = "params" in tree
    return (tree["params"] if is_pipeline else tree), meta, is_pipeline
