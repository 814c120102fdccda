"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
``build/kernels/`` at the root of the checkout (git-ignored), under a name
that carries the hash of its sources and flags: a changed source builds
anew, an unchanged one is reused. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside the library as ``.log``.
Nothing here runs at import time. ``launch`` is the one step every kernel
wrapper ends with: call the C entry on the current stream, raise on its
``cudaError_t``, count the launch.
"""

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading

import torch

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(osp.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks = {}  # one lock per library: different libraries build at once
_locks_guard = threading.Lock()


def find_nvcc():
    """nvcc from PATH, $CUDA_HOME or /usr/local/cuda; raises if absent."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(osp.join(root, "bin", "nvcc"))
    for c in cands:
        if c and osp.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from openibl_tpu_torch/csrc at first use")


def library_path(name, sources):
    """Where the build of ``sources`` (file names under csrc/) goes. The
    hash covers the sources and every header in csrc/ (``*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for s in [*sources, *headers]:
        with open(osp.join(CSRC, s), "rb") as f:
            h.update(s.encode() + b"\0" + f.read())
    return osp.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_library(name, sources):
    """Build (if needed) and load ``lib<name>`` from csrc/ ``sources``.
    Safe to call from several threads: calls for different libraries run
    their nvcc processes in parallel, calls for one library build once."""
    path = library_path(name, sources)
    with _locks_guard:
        lock = _locks.setdefault(path, threading.Lock())
    with lock:
        if not osp.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *[osp.join(CSRC, s) for s in sources]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {name}:\n"
                    f"{res.stdout}\n{res.stderr}")
            with open(path[:-3] + ".log", "w") as f:
                f.write(res.stdout + res.stderr)
            os.replace(tmp, path)  # atomic: processes building at once agree
        return ctypes.CDLL(path)


def launch(wrapper, entry, device, *args):
    """Call the bound C ``entry`` with ``args`` (a tensor passes its
    pointer) and then ``device``'s current stream, with ``device`` the
    current device. Raise if it returns a non-zero ``cudaError_t``; else
    add one to ``wrapper.launches``. ``torch.cuda.device`` sets the device
    only when it is not already current."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    with torch.cuda.device(device):
        err = entry(*ptrs, stream)
    if err:
        raise RuntimeError(f"{entry.__name__} launch failed: cudaError {err}")
    wrapper.launches += 1
