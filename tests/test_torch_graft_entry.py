"""graft_entry_torch.py, the port's twin of __graft_entry__.py: the
multi-device dry run on two gloo ranks on the CPU (the four checks of
``__graft_entry__.dryrun_multichip``, run the way tests/test_graft_entry.py
runs the JAX one: in a subprocess, the way a launcher calls it), the backend
it picks or refuses, and ``entry()``. The 480x640 forward is ``slow``.
"""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import graft_entry_torch  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK")


def test_dryrun_multichip_on_two_gloo_ranks():
    """A launcher's call in a fresh process, with jax blocked there:
    each check prints its line from rank 0 and every rank exits 0."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None\n"
         "import graft_entry_torch\n"
         "graft_entry_torch.dryrun_multichip(2, device='cpu', "
         "backend='gloo')\n"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("baseline DP step ok", "SFRS DP step ok",
                 "sharded eval ok, recall@1=1.00",
                 "sharded PQ search ok, top-1 = planted ids [3, 3, 0, 5]"):
        assert f"dryrun_multichip(2): {line}" in proc.stdout, proc.stdout


@pytest.mark.parametrize("n, device, backend, want", [
    (2, "cpu", "gloo", "gloo"),
    (2, "cuda", "gloo", "gloo"),
    (2, "cpu", None, ValueError),   # never gloo on its own
    (2, "cpu", "nccl", ValueError),
    (2, "cpu", "mpi", ValueError),
])
def test_backend_is_nccl_or_asked_for(n, device, backend, want):
    if isinstance(want, str):
        assert graft_entry_torch._backend(n, device, backend) == want
    else:
        with pytest.raises(want):
            graft_entry_torch._backend(n, device, backend)


def test_backend_without_enough_cards_raises():
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="backend='gloo'"):
        graft_entry_torch._backend(n, "cuda", None)


def test_entry_gives_the_hub_model_and_a_480x640_image():
    fn, (images,) = graft_entry_torch.entry(device="cpu")
    assert tuple(images.shape) == (1, 480, 640, 3)
    assert images.dtype == torch.float32 and not images.any()
    assert fn.pca_dim == 4096 and fn.net_vlad.num_clusters == 64
    assert not fn.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            graft_entry_torch.entry()


@pytest.mark.slow
def test_entry_forward_gives_a_unit_4096_descriptor():
    fn, args = graft_entry_torch.entry(device="cpu")
    with torch.inference_mode():
        out = fn(*args)
    assert tuple(out.shape) == (1, 4096)
    np.testing.assert_allclose(float(out.norm()), 1.0, atol=1e-5)
