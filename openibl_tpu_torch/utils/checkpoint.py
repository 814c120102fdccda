"""Reader for the JAX package's .npz checkpoints, without jax.

openibl_tpu/utils/checkpoint.py stores one npz entry per pytree leaf, keyed
``leaf:<path>`` with "/"-joined dict keys, plus a JSON ``__meta__`` entry.
Two layouts occur: a bare model tree (``leaf:base/conv1_1/w``) and a
pipeline checkpoint (``leaf:params/base/conv1_1/w`` beside optimizer state).
"""

import json

import numpy as np


def load_npz_tree(path):
    """Read a checkpoint into a nested dict of numpy arrays.

    Returns (tree, metadata, is_pipeline): for a pipeline checkpoint the
    tree is its ``params`` subtree and is_pipeline is True."""
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
    is_pipeline = "params" in tree
    return (tree["params"] if is_pipeline else tree), meta, is_pipeline
