import contextlib
import importlib.util
import os

import numpy as np
import torch

from openibl_tpu_torch.utils.logging import Logger  # noqa: F401
from openibl_tpu_torch.utils.meters import AverageMeter  # noqa: F401
from openibl_tpu_torch.utils.padding import pad_index_lists  # noqa: F401


def resolve_device(device):
    """``device`` as a ``torch.device``. Asking for CUDA without a usable
    card raises: the port's entry points default to the card and never
    fall back to the CPU on their own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' asked for, but torch.cuda.is_available() is "
            f"False: pass device='cpu' to run on the CPU")
    return device


def to_numpy(x):
    """Tensor (any device) / list → numpy array (host)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def l2_normalize(x, dim=-1, eps=1e-12):
    """L2-normalize along ``dim``: x / max(||x||, eps), the JAX package's
    utils.l2_normalize, written as x / sqrt(max(||x||², eps²)) so that its
    gradient at a zero vector is finite (1/eps, as
    torch.nn.functional.normalize's), not NaN: the JAX formula's sqrt has an
    infinite slope at 0, and a NetVLAD
    cluster that no location of an image region is assigned to (a sharp
    soft-assignment underflows to exactly 0) has a zero VLAD. Elsewhere the
    value and the gradient are the JAX formula's."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


@contextlib.contextmanager
def f32_precision():
    """Run the block's f32 convolutions and matrix products in full f32:
    cuDNN's and cuBLAS's TF32 off, the caller's settings restored on exit.

    The JAX package runs its f32 descriptor path at full precision, while
    PyTorch lets cuDNN convolutions use TF32 by default. The two flags are
    set and restored directly: ``torch.backends.cudnn.flags()`` would also
    reset ``enabled``, ``benchmark`` and ``deterministic`` to its own
    defaults for the block. The flags are process-wide: a thread running
    beside the block sees them too."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def _is_hdf5(path):
    return str(path).endswith((".h5", ".hdf5"))


def array_file(path):
    """Where the port writes an array file the JAX package writes as HDF5
    (``.h5`` / ``.hdf5``): ``path`` itself when h5py is installed, else
    the same name with ``.npz`` in place of the suffix (numpy holds the
    same arrays under the same names; ``read_arrays`` and the JAX
    package's ``load_pca`` read either)."""
    if _is_hdf5(path) and importlib.util.find_spec("h5py") is None:
        return path[:path.rindex(".")] + ".npz"
    return path


def write_arrays(path, arrays):
    """Write ``arrays`` (name -> array) as HDF5 datasets when ``path`` ends
    in .h5/.hdf5, else as one .npz; through a temporary file renamed into
    place, so a crash never leaves a truncated file. Pass ``path`` through
    ``array_file`` first where h5py may be missing."""
    tmp = str(path) + ".tmp"
    if _is_hdf5(path):
        import h5py

        with h5py.File(tmp, "w") as h5:
            for name, value in arrays.items():
                h5.create_dataset(name, data=np.asarray(value))
    else:
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)


def read_arrays(path, names):
    """The arrays ``names`` of a file ``write_arrays`` (or the JAX package)
    wrote, as a list of numpy arrays in that order."""
    if _is_hdf5(path):
        import h5py

        with h5py.File(path, "r") as h5:
            return [h5[n][...] for n in names]
    with np.load(path) as data:
        return [data[n] for n in names]
