"""Inference hub API: the vgg16_netvlad descriptor model (port of
openibl_tpu/hub.py).

VGG16 + NetVLAD + PCA-whitening to a 4096-d L2-normalized descriptor per
480x640 image. Weights come from a released reference torch checkpoint, one
of the JAX package's .npz checkpoints, or (None) a seeded random init. On a
CUDA device the NetVLAD head runs the fused kernel (ops/netvlad_kernel.py),
as the JAX package's no-grad paths switch on its fused head on the TPU.
"""

import os.path as osp

import numpy as np
import torch

from openibl_tpu_torch import models
from openibl_tpu_torch.data.transforms import TestTransform
from openibl_tpu_torch.models import convert
from openibl_tpu_torch.utils import resolve_device


def _require_loaded(model, state, path):
    """Inference loads must be complete: a model tensor the file does not
    provide (or provides with another shape) would stay RANDOM — fail
    loudly instead of serving garbage descriptors. The PCA layer is exempt
    (trainer checkpoints never carry it; vgg16_netvlad fills it from the PCA
    params file or raises)."""
    bad = [k for k, v in model.state_dict().items()
           if not k.startswith("pca_layer.")
           and (k not in state or tuple(state[k].shape) != tuple(v.shape))]
    if bad:
        raise ValueError(
            f"{path} did not provide {len(bad)} model tensors (e.g. "
            f"{bad[:3]}): wrong file or architecture mismatch — check "
            f"num_clusters/pca_dim against the checkpoint")


def _load_npz(model, path, pca_params):
    """Load a JAX .npz checkpoint; returns the PCA params file to apply."""
    from openibl_tpu_torch.utils.checkpoint import load_npz_tree

    tree, _, is_pipeline = load_npz_tree(path)
    state = convert.params_from_jax(tree)
    _require_loaded(model, state, path)
    if is_pipeline and pca_params is None and "pca" not in tree:
        stem = osp.basename(str(path)).split(".")[0] or "model"
        cand = osp.join(osp.dirname(str(path)) or ".",
                        f"pca_params_{stem}.h5")
        if not osp.isfile(cand):
            # without this the PCA layer silently keeps its RANDOM init and
            # every descriptor is whitened by noise
            raise ValueError(
                f"{path} is a trainer checkpoint without PCA leaves and no "
                f"PCA params file was found (tried {cand}); pass "
                f"pca_params=<path to the .h5 written by training/finalize> "
                f"or use the 32768-d 'embednet' model instead")
        pca_params = cand
    own = model.state_dict()
    model.load_state_dict(
        {k: v for k, v in state.items()
         if k in own and v.shape == own[k].shape},
        strict=False)
    return pca_params


def vgg16_netvlad(pretrained=None, num_clusters=64, pca_dim=4096,
                  pca_params=None, device="cuda"):
    """Build the inference model, in eval mode on ``device`` (the card by
    default; without one this raises unless ``device="cpu"``).

    Args:
      pretrained: a released torch .pth/.pth.tar state dict (loaded
        weights-only), a JAX .npz checkpoint (bare model tree or pipeline
        ``params/...`` layout), or None for the seeded random init.
      pca_params: optional PCA-whitening .h5/.npz (ops.pca.load_pca). For a
        pipeline checkpoint without PCA leaves ``pca_params_<stem>.h5`` next
        to it is used, and its absence is an error.
    Returns: an ``EmbedNetPCA``: images (N, H, W, 3) uint8/float →
      (N, pca_dim) unit-norm descriptors.
    """
    device = resolve_device(device)
    model = models.create(
        "embednetpca",
        net_vlad=models.NetVLAD(num_clusters=num_clusters,
                                fused=device.type == "cuda"),
        pca_dim=pca_dim,
    )
    if pretrained is None:
        pass
    elif str(pretrained).endswith(".npz"):
        pca_params = _load_npz(model, pretrained, pca_params)
    else:
        state = convert.load_torch_checkpoint(pretrained)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        model.load_state_dict(convert.state_from_torch(state))
    if pca_params is not None:
        from openibl_tpu_torch.ops.pca import load_pca, pca_projection

        proj, bias = pca_projection(load_pca(pca_params),
                                    n_components=pca_dim, whiten=True)
        with torch.no_grad():
            model.pca_layer.w.copy_(torch.from_numpy(proj))
            model.pca_layer.b.copy_(torch.from_numpy(bias))
    return model.to(device, memory_format=torch.channels_last).eval()


class DescriptorExtractor:
    """PIL image(s) → (N, 4096) numpy descriptors, the model on ``device``
    (the card by default; see vgg16_netvlad)."""

    def __init__(self, pretrained=None, height=480, width=640,
                 pca_params=None, device="cuda"):
        self.device = torch.device(device)
        self.model = vgg16_netvlad(pretrained, pca_params=pca_params,
                                   device=self.device)
        # raw uint8 pixels: the model subtracts the mean on the device
        self.transform = TestTransform(height, width, device_normalize=True)

    def __call__(self, images):
        if not isinstance(images, (list, tuple)):
            images = [images]
        batch = np.stack([self.transform(img) for img in images])
        with torch.inference_mode():
            desc = self.model(torch.from_numpy(batch).to(self.device))
        return desc.cpu().numpy()
