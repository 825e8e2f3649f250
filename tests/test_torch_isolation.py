"""The port stands alone, and keeps its device and support rules.

* importing every module of dqc_tpu_torch (and chip_smoke.py) in a fresh
  process loads neither JAX nor the JAX package, and no file of either
  says ``import jax`` or names a ``dqc_tpu.`` module;
* entry points default to the CUDA card and raise without one; every n
  from 14 to 30 passes the support check of the cz ring, and the new sizes
  run; modes and paths the port does not run yet (the density-seed modes of
  the multi-term kernels, the gradient of a variable cross gate without a
  span view, dense gates over three groups, the unpaired lane adjoint)
  raise ``NotImplementedError`` naming what is missing, before any state is
  allocated; params that require a gradient get one, and a second backward
  through the same graph raises;
* the kernel build names nvcc and fails loudly without it.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from dqc_tpu_torch import HardwareEfficientAnsatz, config
from dqc_tpu_torch.circuit import plane_scan
from dqc_tpu_torch.circuit.builder import AutoGradCircuit
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.circuit.scan import fuse_layer
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes
from dqc_tpu_torch.ops.kernels import _build

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dqc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dqc_tpu_torch\n"
        "for m in pkgutil.walk_packages(dqc_tpu_torch.__path__, 'dqc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dqc_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('dqc_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15  # every module loaded


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|dqc_tpu)\b(?!_)",
                         text, re.M), path
    assert "import jax" not in text and "dqc_tpu." not in text, path


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert config.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        HardwareEfficientAnsatz(14, 1, entangler="cz")
    with pytest.raises(RuntimeError, match="CUDA"):
        planes.standard_planes(14)
    assert config.resolve_device("cpu") == torch.device("cpu")


def _cnot_ring(n):
    """The CNOT ring's (6, 7) gate in the density-seed form (conj, acc):
    the multi-term kernels run in place only."""
    m = HardwareEfficientAnsatz(n, 1, entangler="cnot", device="cpu")
    terms = plane_scan._dense_cross_expanded_terms(m._layer_consts[0].reshape(4, 4),
                                                   (6, 7), n)
    x = torch.zeros(planes.plane_shape(n))
    planes.apply_cross_terms(x, x, terms, n, conj=True, acc=(x, x))


def _unfactorized_hpair(n):
    config.set_hpair_factorized(False)


def _aliased_merged_apply(n):
    """An in-place apply on the merged top axis (X = 256 at n = 29): the
    kernel takes X = 256 / 512 only in the seed modes."""
    _, X, Xl, _ = planes._merged_view(n, 4)
    x = torch.zeros((1, X * Xl, 8, 128))
    e = torch.zeros((X * Xl, X * Xl))
    tk.high_apply(x, x, e, e)


def _three_group_gate(n):
    """A dense gate over three groups (the xcross item)."""
    layer = AutoGradCircuit(n)
    layer.add_gate((0, 8, 15), var=False)
    plane_scan.check_forward_supported(fuse_layer(layer.tape),
                                       fuse_tape(AutoGradCircuit(n).tape))


def _cross_group_density(n):
    m = HardwareEfficientAnsatz(n, 1, entangler="cz", device="cpu")
    epi = AutoGradCircuit(n)
    epi.get_q2_dens_op_with_grad(n - 1, 0)
    plane_scan.check_forward_supported(m._layer_ftape, fuse_tape(epi.tape))


@pytest.mark.parametrize("n, run, kernel", [
    (15, _cnot_ring, "dual_multi_apply_planes"),
    (22, _unfactorized_hpair, "block_backward_high at X = 256 / 512"),
    (29, _aliased_merged_apply, "seed modes"),
    (30, _cross_group_density, "_cross_density"),
    (22, _three_group_gate, "xcross"),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_unsupported_sizes_name_the_kernel(n, run, kernel):
    """What the port still lacks at the sizes it now runs raises
    NotImplementedError naming the missing kernel, before any state."""
    with pytest.raises(NotImplementedError, match=kernel):
        run(n)


def test_unsupported_n15_names_the_diag_kernel():
    """A diagonal run with variable gates needs the Q reductions of the
    diag backward kernel, which are not ported."""
    x = torch.zeros(planes.plane_shape(15))
    t = (torch.ones((128, 128), dtype=torch.complex64),
         torch.ones((2, 128), dtype=torch.complex64),
         torch.ones((2, 128), dtype=torch.complex64))
    with pytest.raises(NotImplementedError, match="diag_backward_planes"):
        planes.backward_diag_run(x, x, x, x, t, t, with_q=True)
    with pytest.raises(NotImplementedError, match="diag_backward_planes"):
        tk.diag_backward(x, x, x, x, *[x[0]] * 12, with_q=True)


@pytest.mark.parametrize("n", range(14, 31))
def test_every_size_passes_the_support_check(n):
    """The cz ring's layer program and density epilogue run at every n the
    plane layout holds: no plan item or density is refused."""
    m = HardwareEfficientAnsatz(n, 1, entangler="cz", device="cpu")
    plane_scan.check_forward_supported(m._layer_ftape, m._epi_ftape)
    kinds = {item[0] for item in plane_scan.plane_program(m._layer_ftape)}
    assert kinds <= {"dense", "ddual", "dhigh", "diag", "hpair"}, kinds


@pytest.mark.parametrize("n", [15, 16, 22, 23])
def test_new_sizes_run_at_zero_params(n):
    """params = 0: the identity circuit, magnetization n and a zero
    gradient, through the small-X group 2 (n = 15, 16) or the merged top
    axis (n = 22, 23), with the scan rotation both ways (L = 2)."""
    m = HardwareEfficientAnsatz(n, 2, entangler="cz", device="cpu")
    p = torch.zeros(2, n, 3, requires_grad=True)
    loss = m.magnetization(p)
    loss.backward()
    assert loss.item() == n
    assert p.grad.abs().max().item() < 1e-6


def test_cnot_ring_names_the_cross_kernels():
    """The CNOT ring runs (params = 0: magnetization 14, up to the f32
    rounding of the CNOT's Schmidt terms). A variable cross gate without a
    span view runs forward, but its gradient needs _plane_pair_grad: asking
    for one raises before any state."""
    m = HardwareEfficientAnsatz(14, 1, entangler="cnot", device="cpu")
    assert abs(m.magnetization(torch.zeros(1, 14, 3)).item() - 14) <= 1e-5 * 14
    layer = AutoGradCircuit(14)
    layer.add_q2_var_gate(6, 7)
    ftape = fuse_layer(layer.tape)
    epi = AutoGradCircuit(14)
    epi.get_q1_dens_op_with_grad(0)
    plane_scan.check_forward_supported(ftape, fuse_tape(epi.tape))
    with pytest.raises(NotImplementedError, match="_plane_pair_grad"):
        plane_scan.check_backward_supported(ftape)
    gate = torch.eye(4, dtype=torch.complex64).reshape(-1)[None].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="_plane_pair_grad"):
        plane_scan.std_scan_with_epilogue(None, ftape, fuse_tape(epi.tape), (),
                                          (gate,), (), device="cpu")


def test_below_plane_size_raises():
    m = HardwareEfficientAnsatz(10, 1, entangler="cz", device="cpu")
    with pytest.raises(NotImplementedError, match="plane"):
        m.magnetization(torch.zeros(1, 10, 3))


def test_requires_grad_raises():
    """Params that require a gradient get one (the gradient of the
    magnetization at params = 0 is 0: every <Z_i> = cos alpha_i sits at its
    maximum); only a second backward through the same graph raises, as the
    first consumed the saved final planes."""
    m = HardwareEfficientAnsatz(14, 1, entangler="cz", device="cpu")
    p = torch.zeros(1, 14, 3, requires_grad=True)
    loss = m.magnetization(p)
    loss.backward(retain_graph=True)
    assert loss.item() == 14 and p.grad.shape == (1, 14, 3)
    assert p.grad.abs().max().item() < 1e-6
    with pytest.raises(RuntimeError, match="consumed"):
        loss.backward()
    # the same params without a gradient run
    assert float(m.magnetization(p.detach())) == 14


@pytest.mark.parametrize("j, kernel", [(0, "block_backward_lane"),
                                       (1, "block_backward_sublane")])
def test_unpaired_minor_backward_names_the_kernel(j, kernel):
    """The unpaired lane adjoint is not ported and raises naming its
    kernel; the unpaired sublane adjoint runs (block_backward_sublane's
    plain version on the CPU): F <- Einv F, B <- E^T B and the pair gram."""
    x = torch.zeros(planes.plane_shape(14))
    eye = torch.eye(128, dtype=torch.complex64)
    if j == 0:
        with pytest.raises(NotImplementedError, match=kernel):
            planes.backward_block(x, x, x, x, eye, eye, j, 14)
        return
    assert kernel in tk.KernelSet._fields
    f = torch.randn((1, 128, 128), generator=torch.Generator().manual_seed(3))
    fr, fi, br, bi, T0 = planes.backward_block(f, 0 * f, f, f, 2 * eye, eye,
                                               j, 14)
    assert torch.equal(fr, 2 * f) and torch.equal(br, f)
    want = torch.einsum("axc,ayc->xy", f, 2 * f)
    torch.testing.assert_close(T0, torch.complex(want, want), rtol=1e-5,
                               atol=1e-4)


def test_var_diag_run_q_names_the_kernels():
    x = torch.zeros((1, 128, 128, 128))
    with pytest.raises(NotImplementedError, match="diag_q"):
        planes.backward_dhigh(x, x, x, x, None, None, None, None, 2, 21,
                              with_q=True)


@pytest.mark.parametrize("setter, value", [
    (config.set_kernel_dot_mode, "bf16x3"),
    (config.set_state_storage, "f16"),
    (config.set_state_storage, "mixed"),
    (config.set_bwd_kernel_dot_mode, "bf16x3"),
    (config.set_gram_kernel_dot_mode, "bf16x3"),
])
def test_unported_modes_raise(setter, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        setter(value)
    setter("f32")  # the ported mode is accepted


@pytest.mark.parametrize("setter, getter", [
    (config.set_bwd_kernel_dot_mode, config.bwd_kernel_dot_mode),
    (config.set_gram_kernel_dot_mode, config.gram_kernel_dot_mode),
])
def test_backward_dot_modes_resolve_to_f32(setter, getter):
    """"auto" resolves to "f32" until bf16x3 is ported (the JAX package
    resolves the gram mode's "auto" to "bf16x3"); other names are errors."""
    try:
        setter("auto")
        assert getter() == "f32"
        setter("f32")
        assert getter() == "f32"
        with pytest.raises(ValueError):
            setter("tf32")
    finally:
        setter("auto")


def test_wrong_params_shape_raises():
    m = HardwareEfficientAnsatz(14, 2, entangler="cz", device="cpu")
    with pytest.raises(ValueError, match="params"):
        m.densities(torch.zeros(1, 14, 3))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_targets_follow_the_sources():
    """Each library's file name carries a hash of its source, the shared
    header and the flags, inside the git-ignored build directory."""
    names = {n: _build._target(n) for n in _build.LIBRARIES}
    assert len(set(names.values())) == len(names)
    for n, t in names.items():
        assert t.parent == ROOT / "build" / "dqc_tpu_torch"
        assert t.name.startswith(f"lib{n}-") and t.suffix == ".so"
        assert (ROOT / "dqc_tpu_torch" / "csrc" / f"{n}.cu").exists()
    assert "build/dqc_tpu_torch/" in (ROOT / ".gitignore").read_text()
