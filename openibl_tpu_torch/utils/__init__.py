import numpy as np
import torch


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
    """L2-normalize along ``dim`` (safe at zero norm); the same formula as
    openibl_tpu.utils.l2_normalize: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)
