"""The port's Mosaic layout probes (openibl_tpu_torch/tools/mosaic_probe.py)
against scripts/mosaic_probe.py, and on a GPU each CUDA probe kernel against
its plain version.

The script's seven Pallas kernels run here in interpret mode: its ``pl`` is
replaced by a namespace whose ``pallas_call`` adds ``interpret=True`` and
records each kernel's output. The port's plain versions, on the port's own
inputs, must give those outputs bit for bit, except the K=3 product (P5),
whose f32 sums may run in another order: atol 1e-5 there. The tests marked
``cuda`` run only on a GPU, without the JAX-side conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_mosaic_probe.py``.
"""

import importlib.util
import os.path as osp
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch.tools import mosaic_probe as mp  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_ATOL = 1e-5  # P5 against Pallas: f32 sums of 3 products in another order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_mosaic_probe.py`")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_rows():
    """{key: (row name, status, recorded output)} of the script's probes,
    its kernels run in interpret mode on the CPU."""
    jax = pytest.importorskip("jax")  # not on the GPU machine: -m cuda only
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probe", osp.join(ROOT, "scripts", "mosaic_probe.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    real_pl, outputs = script.pl, []

    def pallas_call(kernel, **kw):
        fn = real_pl.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            jax.debug.callback(lambda o: outputs.append(np.asarray(o)), out)
            return out
        return run

    probes = {"P1": lambda: script.probe_concat(3, 9),
              "P2": lambda: script.probe_concat(64, 9),
              "P3": script.probe_sublane_offsets,
              "P4": script.probe_sublane_stride2,
              "P5": script.probe_k3_dot,
              "P6": script.probe_take_lut,
              "P7": script.probe_onehot_dot}
    rows = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(script, "pl",
                      types.SimpleNamespace(pallas_call=pallas_call))
        for key, probe in probes.items():
            name, status = probe()
            jax.effects_barrier()
            rows[key] = (name, status, outputs.pop())
            assert not outputs
    return rows


def test_probes_are_the_scripts_seven_in_order():
    assert [p.key for p in mp.PROBES] == [f"P{i}" for i in range(1, 8)]


@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_plain_version_gives_the_pallas_output(jax_rows, probe):
    name, status, jax_out = jax_rows[probe.key]
    assert status == "OK"  # the Pallas kernel against the script's numpy
    assert probe.name == name
    out = probe.plain(*probe.tensors("cpu"), **probe.kwargs).numpy()
    assert out.dtype == jax_out.dtype and out.shape == jax_out.shape
    if probe.atol:
        np.testing.assert_allclose(out, jax_out, rtol=0, atol=JAX_ATOL)
    else:
        np.testing.assert_array_equal(out, jax_out)


@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_site_is_the_scripts_probe_function(probe):
    with open(osp.join(ROOT, "scripts", "mosaic_probe.py")) as f:
        line = f.read().splitlines()[probe.site - 1]
    assert line.startswith("def probe_"), line


@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_cpu_probe_takes_the_plain_version(probe):
    before = probe.kernel.launches
    name, status, out = probe.run("cpu")
    assert (name, status) == (probe.name, "OK")
    assert probe.kernel.launches == before
    assert out.device.type == "cpu" and out.dtype == torch.float32


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call, err, match", [
    (lambda: mp.concat(_f32(8, 27).double(), 3), TypeError, "float32"),
    (lambda: mp.concat(_f32(8, 27), 4), ValueError, "blocks of 4"),
    (lambda: mp.concat(_f32(8, 27, 1), 3), ValueError, "2 dims"),
    (lambda: mp.concat(_f32(27, 8).T, 3), ValueError, "contiguous"),
    (lambda: mp.concat(torch.zeros(8, 27, device="meta"), 3), ValueError,
     "no kernel for device meta"),
    (lambda: mp.sublane_offsets(_f32(2, 256)), ValueError, ">= 3 rows"),
    (lambda: mp.sublane_offsets(_f32(256, 18).T), ValueError, "contiguous"),
    (lambda: mp.sublane_stride2(_f32(31, 256)), ValueError, "even"),
    (lambda: mp.sublane_stride2(_f32(32, 256).half()), TypeError, "float32"),
    (lambda: mp.k3_dot(_f32(128, 3), _f32(4, 64)), ValueError, "multiply"),
    (lambda: mp.k3_dot(_f32(128, 3), _f32(64, 3).T), ValueError,
     "contiguous"),
    (lambda: mp.take_lut(_f32(8, 256), _i32(8, 128).long()), TypeError,
     "int32"),
    (lambda: mp.take_lut(_f32(8, 257), _i32(8, 128)), ValueError,
     "1..256 columns"),
    (lambda: mp.take_lut(_f32(8, 256), _i32(4, 128)), ValueError, "idx"),
    (lambda: mp.onehot_dot(_f32(8, 256), _i32(128)), ValueError, "2 dims"),
    (lambda: mp.onehot_dot(_f32(8, 256), _i32(2, 128)), ValueError, "idx"),
    (lambda: mp.onehot_dot(_f32(256, 8).T, _i32(1, 128)), ValueError,
     "contiguous"),
])
def test_wrappers_reject_bad_inputs(call, err, match):
    with pytest.raises(err, match=match):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("probe", mp.PROBES, ids=lambda p: p.key)
def test_cuda_kernel_matches_plain(probe, cuda_device):
    args = probe.tensors(cuda_device)
    before = probe.kernel.launches
    out = probe.kernel(*args, **probe.kwargs)
    torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    assert out.device.type == "cuda"
    want = probe.plain(*(a.cpu() for a in args), **probe.kwargs)
    assert probe.agrees(out.cpu(), want)
    assert probe.run(cuda_device)[1] == "OK"


@pytest.mark.cuda
def test_cuda_kernels_at_ragged_sizes(cuda_device):
    """Shapes that fill no tile: the kernels mask their edges."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    cases = [(mp.concat, mp.concat_plain, (rand(5, 21),), {"width": 7}),
             (mp.sublane_offsets, mp.sublane_offsets_plain, (rand(37, 45),),
              {}),
             (mp.sublane_stride2, mp.sublane_stride2_plain, (rand(18, 33),),
              {}),
             (mp.take_lut, mp.take_lut_plain,
              (rand(11, 100), torch.randint(0, 100, (11, 77), generator=g,
                                            device=cuda_device,
                                            dtype=torch.int32)), {}),
             (mp.onehot_dot, mp.onehot_dot_plain,
              (rand(11, 100), torch.randint(0, 100, (1, 77), generator=g,
                                            device=cuda_device,
                                            dtype=torch.int32)), {})]
    for kernel, plain, args, kw in cases:
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), plain(*(a.cpu() for a in args), **kw))
    x, w = rand(77, 5), rand(5, 33)
    torch.testing.assert_close(mp.k3_dot(x, w).cpu(), x.cpu() @ w.cpu(),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_tool_prints_every_row_ok(cuda_device, capsys):
    assert mp.main(["--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("backend: cuda")
    assert out.count(" OK\n") == len(mp.PROBES)
