"""Weight conversion into the port's state dicts.

Two sources:

  * the JAX package's parameter tree (numpy leaves, as read from its .npz
    checkpoints by utils/checkpoint.py): conv w HWIO → OIHW; NetVLAD
    assign_w (C, K) and centroids (K, C) and the PCA w (D_in, D_out) keep
    their layouts;
  * released reference torch checkpoints (``base_model.base.<i>.*``,
    ``net_vlad.conv.weight`` (K, C, 1, 1), ``net_vlad.centroids``,
    ``pca_layer.weight`` (D_out, D_in, 1, 1), optional ``module.`` prefix),
    loaded weights-only.

Port state-dict keys: ``base.<conv>.weight/bias``, ``net_vlad.assign_w``,
``net_vlad.centroids``, ``pca_layer.w``, ``pca_layer.b``.

``params_to_jax`` is the inverse of ``params_from_jax``: the checkpoint
writer stores the port's parameters in the JAX layouts, and a round trip
JAX → port → JAX gives the same bits (transposes and copies only).

``quant_state_from_jax`` / ``quant_state_to_jax`` carry the int8 backbone's
tree (openibl_tpu/ops/quant.py: ``wq`` HWIO int8, ``m``/``bq`` or
``sxsw``/``b``, ``_meta.s_in``, the float prefix's ``w``/``b``) to and from
the flat state of ``ops.quant.QuantVGG16`` (``wq`` (Cout, 3, 3, Cin), the
prefix OIHW), with the same bits.
"""

import numpy as np
import torch

# torchvision vgg16.features conv indices → layer names
TORCH_VGG16_CONV_INDEX = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}


def load_torch_checkpoint(path):
    """torch.load without opting into pickle execution.

    Plain tensor state dicts load under ``weights_only=True`` directly.
    Reference-style full training checkpoints also store numpy-scalar
    metadata (e.g. ``best_recall5``), which the weights-only unpickler
    rejects; retry with exactly the numpy scalar-reconstruction globals
    allowed — still never arbitrary pickle execution.
    """
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        allow = [np.dtype, np.ndarray, np.float64, np.float32,
                 np.int64, np.int32]
        multiarray = getattr(np, "_core", np.core).multiarray
        for name in ("scalar", "_reconstruct"):
            fn = getattr(multiarray, name, None)
            if fn is not None:
                allow.append(fn)
        try:  # numpy>=1.25 pickles dtypes via the numpy.dtypes classes
            from numpy import dtypes as _np_dtypes

            allow += [getattr(_np_dtypes, n) for n in dir(_np_dtypes)
                      if n.endswith("DType")]
        except ImportError:
            pass
        with torch.serialization.safe_globals(allow):
            return torch.load(path, map_location="cpu", weights_only=True)


def torch_checkpoint_state(path):
    """A released reference .pth/.pth.tar (a state dict, or a training
    checkpoint holding one under ``state_dict``), loaded weights-only, as
    a port state dict (``state_from_torch``)."""
    state = load_torch_checkpoint(path)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state_from_torch(state)


def _tensor(v):
    return torch.from_numpy(np.array(v, np.float32, order="C"))  # a copy


def vgg16_state_from_jax(tree, prefix=""):
    """JAX VGG16 params {conv: {w HWIO, b}} → {prefix+conv.weight OIHW, ...}."""
    state = {}
    for name, p in tree.items():
        state[f"{prefix}{name}.weight"] = _tensor(
            np.asarray(p["w"]).transpose(3, 2, 0, 1))
        state[f"{prefix}{name}.bias"] = _tensor(p["b"])
    return state


def params_from_jax(tree):
    """JAX EmbedNet/EmbedNetPCA param tree {base, vlad, pca?} → state dict.
    Subtrees absent from ``tree`` are absent from the result."""
    state = vgg16_state_from_jax(tree.get("base", {}), prefix="base.")
    if "vlad" in tree:
        state["net_vlad.assign_w"] = _tensor(tree["vlad"]["assign_w"])
        state["net_vlad.centroids"] = _tensor(tree["vlad"]["centroids"])
    if "pca" in tree:
        state["pca_layer.w"] = _tensor(tree["pca"]["w"])
        state["pca_layer.b"] = _tensor(tree["pca"]["b"])
    return state


def _array(t):
    """A C-ordered numpy copy, never a view of a live tensor."""
    return np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                    order="C")


def params_to_jax(state):
    """Port state dict (or a module's) → the JAX package's parameter tree
    of numpy arrays: conv weight OIHW → w HWIO, NetVLAD and PCA as they
    are. Entries the JAX trees do not have are left out."""
    tree = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] == "base" and len(parts) == 3:
            leaf = tree.setdefault("base", {}).setdefault(parts[1], {})
            if parts[2] == "weight":
                leaf["w"] = np.ascontiguousarray(
                    _array(value).transpose(2, 3, 1, 0))
            else:
                leaf["b"] = _array(value)
        elif parts[0] == "net_vlad":
            tree.setdefault("vlad", {})[parts[1]] = _array(value)
        elif parts[0] == "pca_layer":
            tree.setdefault("pca", {})[parts[1]] = _array(value)
    return tree


def _strip(key):
    return key[len("module."):] if key.startswith("module.") else key


def _torch_sd(state_dict):
    return {_strip(k): v.detach().float() for k, v in state_dict.items()
            if isinstance(v, torch.Tensor)}


def vgg16_state_from_torch(state_dict):
    """The 13 VGG16 convolutions of a torch state dict (a reference model,
    or the torchvision-indexed ``features`` of the MatConvNet backbone
    ``vd16_offtheshelf_conv5_3_max.pth``) → ``base.<conv>.weight/bias``."""
    sd = _torch_sd(state_dict)
    state = {}
    for prefix in ("base_model.base.", "base.", ""):
        names = {idx: name for idx, name in TORCH_VGG16_CONV_INDEX.items()
                 if f"{prefix}{idx}.weight" in sd}
        if len(names) == len(TORCH_VGG16_CONV_INDEX):
            for idx, name in names.items():
                state[f"base.{name}.weight"] = sd[f"{prefix}{idx}.weight"]
                state[f"base.{name}.bias"] = sd[f"{prefix}{idx}.bias"]
            break
    else:
        raise ValueError(
            "could not locate all 13 VGG16 conv layers in state dict "
            f"(keys sample: {list(sd)[:5]})")
    return state


def state_from_torch(state_dict):
    """Reference torch state dict (EmbedNetPCA layout, or EmbedNet without
    ``pca_layer.*``) → port state dict."""
    sd = _torch_sd(state_dict)
    state = vgg16_state_from_torch(state_dict)
    w = sd["net_vlad.conv.weight"]  # (K, C, 1, 1)
    state["net_vlad.assign_w"] = w[:, :, 0, 0].t().contiguous()  # (C, K)
    state["net_vlad.centroids"] = sd["net_vlad.centroids"]
    if "pca_layer.weight" in sd:
        pw = sd["pca_layer.weight"]  # (D_out, D_in, 1, 1)
        state["pca_layer.w"] = pw[:, :, 0, 0].t().contiguous()
        state["pca_layer.b"] = sd["pca_layer.bias"]
    return state


def quant_state_from_jax(qtree):
    """The JAX package's quantized VGG16 tree (``quantize_vgg16``) → the
    flat state of ``ops.quant.QuantVGG16``."""
    state = {}
    for name, p in qtree.items():
        if name == "_meta":
            state["s_in"] = torch.tensor(np.float32(p["s_in"]))
        elif "wq" in p:
            state[f"{name}.wq"] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["wq"], np.int8).transpose(3, 0, 1, 2)))
            for k in ("m", "bq", "sxsw", "b"):
                if k in p:
                    state[f"{name}.{k}"] = _tensor(p[k])
        else:
            state.update(vgg16_state_from_jax({name: p}))
    return state


def quant_state_to_jax(state):
    """``QuantVGG16``'s state (or ``quantize_vgg16``'s) → the JAX package's
    quantized tree of numpy arrays; the inverse of quant_state_from_jax."""
    tree = {}
    for key, value in state.items():
        if key == "s_in":
            tree["_meta"] = {"s_in": np.float32(_array(value))}
            continue
        name, leaf = key.split(".")
        arr = _array(value)
        if leaf == "wq":
            arr = np.ascontiguousarray(arr.transpose(1, 2, 3, 0))
        elif leaf == "weight":
            leaf, arr = "w", np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            leaf = "b"
        tree.setdefault(name, {})[leaf] = arr
    return tree
