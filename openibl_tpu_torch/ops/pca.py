"""PCA-whitening (port of openibl_tpu/ops/pca.py).

Parameters are a dict {U (D, k), lams (k,), mu (D, 1)}, read from and
written to the JAX package's .h5 (reference-interoperable) or .npz files.
``pca_train`` fits them on the descriptors' device in f32 (TF32 off):
covariance, or the dual (gram) form when D > N, then ``torch.linalg.eigh``
in place of the JAX package's ``jnp.linalg.eigh``; whitening folds
diag(1/sqrt(lams)) into the projection. ``PCA`` is the train → save /
load → infer object of the training pipeline.
"""

import os

import numpy as np
import torch

from openibl_tpu_torch.utils import (f32_precision, l2_normalize, read_arrays,
                                     write_arrays)


def pca_train(x, n_components=4096):
    """PCA parameters of descriptors ``x`` (N, D), a tensor (fit on its
    device) or a numpy array (fit on the CPU). Returns numpy U (D, k), lams
    (k,) and mu (D, 1), k = min(n_components, rank side), eigenvalues
    floored at 1e-9 and sorted descending, as the JAX pca_train."""
    with f32_precision():
        x = torch.as_tensor(x).to(torch.float32).T  # (D, N)
        n_dims, n_points = x.shape
        mu = torch.mean(x, dim=1, keepdim=True)
        xc = x - mu
        do_dual = n_dims > n_points
        cov = (torch.matmul(xc.T, xc) if do_dual
               else torch.matmul(xc, xc.T)) / (n_points - 1)
        lams, u = torch.linalg.eigh(cov)  # ascending
        k = min(n_components, cov.shape[0])
        order = torch.argsort(-lams, stable=True)[:k]
        lams = torch.clamp(lams[order], min=1e-9)
        u = u[:, order]
        if do_dual:
            # U_primal = Xc @ U_dual @ diag(1/sqrt(lams * (N-1)))
            u = torch.matmul(
                xc, u * (1.0 / torch.sqrt(lams * (n_points - 1)))[None, :])
    return {"U": u.cpu().numpy(), "lams": lams.cpu().numpy(),
            "mu": mu.cpu().numpy()}


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


def save_pca(params, path):
    """Write PCA params (U, lams, mu and Utmu, the file the JAX package's
    and the reference's load_pca read) as .h5, or as .npz for any other
    suffix (``utils.write_arrays``)."""
    u, mu = np.asarray(params["U"]), np.asarray(params["mu"])
    write_arrays(path, {"U": u, "lams": params["lams"], "mu": mu,
                        "Utmu": u.T @ mu})


def load_pca(path):
    return dict(zip(("U", "lams", "mu"),
                    read_arrays(path, ("U", "lams", "mu"))))


class PCA:
    """train → save, or load → infer, as the reference's PCA object."""

    def __init__(self, n_components=4096, whiten=True, params_path=None):
        self.n_components = n_components
        self.whiten = whiten
        self.params_path = params_path
        self._proj = None
        self._bias = None

    def train(self, x):
        params = pca_train(x, self.n_components)
        if self.params_path:
            save_pca(params, self.params_path)
        self._proj, self._bias = pca_projection(
            params, self.n_components, self.whiten)
        return params

    def load(self):
        self._proj, self._bias = pca_projection(
            load_pca(self.params_path), self.n_components, self.whiten)
        return self

    def infer(self, x):
        """x (N, D) tensor → (N, k) projected, L2-normalized, on x's
        device."""
        if self._proj is None:
            self.load()
        with f32_precision():
            return pca_apply(x, self._proj, self._bias)
