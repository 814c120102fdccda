"""PCA-whitening, inference half (port of openibl_tpu/ops/pca.py).

Parameters are a dict {U (D, k), lams (k,), mu (D, 1)} read from the JAX
package's .h5 (reference-interoperable) or .npz files. ``pca_train`` comes
with the training slice (ROADMAP Queue 1 item 9).
"""

import numpy as np
import torch

from openibl_tpu_torch.utils import l2_normalize


def pca_projection(params, n_components=None, whiten=True):
    """(D, k) projection and (k,) bias, numpy f32: optionally folds
    diag(1/sqrt(lams)) into U; inference is l2norm(x @ U - U^T mu)."""
    u = np.asarray(params["U"])
    lams = np.asarray(params["lams"])
    mu = np.asarray(params["mu"])
    if n_components is not None:
        u = u[:, :n_components]
        lams = lams[:n_components]
    if whiten:
        u = u * (1.0 / np.sqrt(lams))[None, :]
    bias = -(u.T @ mu).reshape(-1)
    return u.astype(np.float32), bias.astype(np.float32)


def pca_apply(x, proj, bias):
    """Project + L2-normalize: x (N, D) tensor, proj (D, k), bias (k,)."""
    proj = torch.as_tensor(proj, dtype=torch.float32, device=x.device)
    bias = torch.as_tensor(bias, dtype=torch.float32, device=x.device)
    return l2_normalize(torch.matmul(x.float(), proj) + bias, dim=-1)


def load_pca(path):
    if str(path).endswith(".h5"):
        import h5py

        with h5py.File(path, "r") as h5:
            return {"U": h5["U"][...], "lams": h5["lams"][...],
                    "mu": h5["mu"][...]}
    with np.load(path) as data:
        return {k: data[k] for k in ("U", "lams", "mu")}
