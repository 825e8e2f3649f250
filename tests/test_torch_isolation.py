"""The port stands alone, and keeps its device and support rules.

* importing every module of dqc_tpu_torch (and chip_smoke.py) in a fresh
  process loads neither JAX nor the JAX package, and no file of either
  says ``import jax`` or names a ``dqc_tpu.`` module;
* entry points default to the CUDA card and raise without one; every n
  from 14 to 30 plans the cz ring's layer from the kernel items, and the
  new sizes run; the modes earlier slices refused (the unfactorized hpair,
  the in-place merged apply at X = 256 / 512, scan mode below the plane
  size) run and agree with the routes they stand beside; the paths earlier
  slices refused (the seed of a
  density over three groups without a span view, a variable diagonal run
  folded into a high sweep, the gradient of a variable cross gate without
  a span view, dense gates over three groups, the unpaired lane adjoint)
  run and agree with the fused engine; params that require a gradient get
  one, and a second backward through the same graph raises;
* the kernel build names nvcc and fails loudly without it.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dqc_tpu_torch import HardwareEfficientAnsatz, QAOAMaxCut, VQEIsing, config
from dqc_tpu_torch.circuit import plane_scan
from dqc_tpu_torch.circuit.builder import AutoGradCircuit
from dqc_tpu_torch.circuit.fused_autograd import fused_tape_forward
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


def _unfactorized_hpair(n):
    """The expanded merged sweep (X = 256 at n = 22) gives the factorized
    sweep's value and gradient (one layer, random params)."""
    p = torch.tensor(np.random.default_rng(n).standard_normal((1, n, 3)),
                     dtype=torch.float32)
    out = []
    for factorized in (False, True):
        config.set_hpair_factorized(factorized)
        try:
            m = HardwareEfficientAnsatz(n, 1, entangler="cz", device="cpu")
            q = p.clone().requires_grad_(True)
            loss = m.magnetization(q)
            loss.backward()
        finally:
            config.set_hpair_factorized(True)
        out.append((loss.item(), q.grad))
    (v0, g0), (v1, g1) = out
    assert abs(v0 - v1) <= 1e-5 * n
    assert (g0 - g1).abs().max().item() <= 2e-5


def _aliased_merged_apply(n):
    """An in-place apply on the merged top axis (X = 256 at n = 29), on a
    small view: the plain version's E x."""
    _, X, Xl, _ = planes._merged_view(n, 4)
    g = torch.Generator().manual_seed(n)
    x = torch.randn((1, X * Xl, 8, 128), generator=g)
    e = torch.randn((X * Xl, X * Xl), generator=g)
    yr, yi = tk.high_apply(x, torch.zeros_like(x), e, torch.zeros_like(e))
    want = torch.matmul(e, x.reshape(X * Xl, -1)).reshape(x.shape)
    torch.testing.assert_close(yr, want, rtol=1e-5, atol=1e-4)
    assert yi.abs().max().item() == 0


@pytest.mark.parametrize("n, run, kernel", [
    (22, _unfactorized_hpair, "block_backward_high at X = 256 / 512"),
    (29, _aliased_merged_apply, "seed modes"),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_unsupported_sizes_name_the_kernel(n, run, kernel):
    """What earlier slices refused at the sizes they ran now runs: the
    unfactorized hpair (``kernel`` names the kernel it needed, the high
    adjoint at X = 256 / 512) and the in-place merged apply, beyond the
    seed modes."""
    run(n)


def _three_group_density_seed(n):
    """A density over three groups that no span view holds: its seed is
    the >2-group dense apply (xcross) on the sub-blocks."""
    c = AutoGradCircuit(n)
    c.add_q1_var_gate(0)
    c.add_q1_var_gate(8)
    c.get_dens_op((0, 8, n - 1), with_grad=True)
    return c


def _three_group_gate(n):
    """A variable dense gate over three groups (the xcross item)."""
    c = AutoGradCircuit(n)
    c.add_q1_var_gate(0)
    c.add_gate((0, 8, n - 1), var=True, unitary=False)
    c.get_q1_dens_op_with_grad(0)
    c.get_q2_dens_op_with_grad(8, n - 1)
    return c


def _var_run_in_dhigh(n):
    """A variable ZZ across groups 1 and 2 next to a dense group-2 block:
    the run folds into the high sweep (block_backward_high diag_q)."""
    c = AutoGradCircuit(n)
    c.add_q1_var_gate(13)
    c.add_q1_var_gate(14)
    c.get_q1_dens_op_with_grad(13)
    c.add_q2_var_gate_diag(13, 14)
    c.add_q1_var_gate(15)
    c.get_q1_dens_op_with_grad(15)
    c.get_q2_dens_op_with_grad(14, 13)
    return c


def _var_cross_gate(n):
    """A variable dense gate across the minor groups (no span view: its
    gradient is _plane_pair_grad), and an unpaired lane block."""
    c = AutoGradCircuit(n)
    c.add_q1_var_gate(3)
    c.add_q2_var_gate(6, 7)
    c.get_q1_dens_op_with_grad(7)
    c.get_q1_dens_op_with_grad(3)
    return c


@pytest.mark.parametrize("n, build, kind", [
    (17, _three_group_density_seed, None),
    (17, _three_group_gate, "xcross"),
    (17, _var_run_in_dhigh, "dhigh"),
    (14, _var_cross_gate, "dcross"),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_formerly_refused_paths_run(n, build, kind):
    """The paths earlier slices refused run on the plane tape (the plain
    versions on the CPU) and agree with the fused engine, densities and
    gradients within 2e-5 max(1, |x|)."""
    c = build(n)
    ftape = fuse_tape(c.tape)
    if kind is not None:
        assert kind in {item[0] for item in plane_scan.plane_program(ftape)}
    rng = np.random.default_rng(n)
    gates = []
    for inst in c.tape.gates(var=True):
        d = 1 << inst.k
        q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
        gates.append((q if inst.kind.name == "GATE" else np.exp(
            1j * rng.uniform(0, 6.3, d))).astype(np.complex64).reshape(-1))
    state = c.initial_state("cpu")
    out = []
    for engine in (plane_scan.plane_tape_forward, fused_tape_forward):
        vg = [torch.tensor(g, requires_grad=True) for g in gates]
        dens = engine(ftape, state, vg, ())
        loss = sum(torch.einsum("ij,ji->", d, d).real for d in dens)
        loss.backward()
        out.append((torch.stack([d.reshape(-1) for d in dens]) if
                    len({d.numel() for d in dens}) == 1 else
                    torch.cat([d.reshape(-1) for d in dens]),
                    [v.grad for v in vg]))
    (d1, g1), (d2, g2) = out
    torch.testing.assert_close(d1, d2, rtol=0, atol=2e-5)
    for a, b in zip(g1, g2):
        assert (a - b).abs().max().item() <= 2e-5 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("n", range(14, 31))
def test_every_size_passes_the_support_check(n):
    """The cz ring's layer program and density epilogue run at every n the
    plane layout holds: no plan item or density is refused."""
    m = HardwareEfficientAnsatz(n, 1, entangler="cz", device="cpu")
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
    span view runs both ways in scan mode: its gradient comes from
    _plane_pair_grad (at the identity gate on |0..0>, d rho_00 / d G is 2
    at G_00 and 0 elsewhere)."""
    m = HardwareEfficientAnsatz(14, 1, entangler="cnot", device="cpu")
    assert abs(m.magnetization(torch.zeros(1, 14, 3)).item() - 14) <= 1e-5 * 14
    layer = AutoGradCircuit(14)
    layer.add_q2_var_gate(6, 7)
    ftape = fuse_layer(layer.tape)
    epi = AutoGradCircuit(14)
    epi.get_q1_dens_op_with_grad(0)
    gate = torch.eye(4, dtype=torch.complex64).reshape(-1)[None].requires_grad_(True)
    dens = plane_scan.std_scan_with_epilogue(None, ftape, fuse_tape(epi.tape), (),
                                             (gate,), (), device="cpu")
    dens[0][0, 0].real.backward()
    assert abs(dens[0][0, 0].item() - 1) <= 1e-6
    want = torch.zeros_like(gate)
    want[0, 0] = 2  # rho_00 = |G_00 psi_0|^2 on |0..0>
    assert (gate.grad - want).abs().max().item() <= 1e-6


def test_below_plane_size_raises():
    """Below the plane size scan mode runs the fallback off the planes and
    equals ``scan=False`` (value and gradient)."""
    p = torch.tensor(np.random.default_rng(10).standard_normal((1, 10, 3)),
                     dtype=torch.float32)
    out = []
    for scan in (True, False):
        m = HardwareEfficientAnsatz(10, 1, entangler="cz", device="cpu", scan=scan)
        q = p.clone().requires_grad_(True)
        loss = m.magnetization(q)
        loss.backward()
        out.append((loss.item(), q.grad))
    (v0, g0), (v1, g1) = out
    assert abs(v0 - v1) <= 1e-5
    assert (g0 - g1).abs().max().item() <= 1e-5


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
    """The unpaired lane and sublane adjoints run on their kernels (the
    plain versions on the CPU): F <- Einv F, B <- E^T B on the group's axis
    and the pair gram."""
    eye = torch.eye(128, dtype=torch.complex64)
    assert kernel in tk.KernelSet._fields
    f = torch.randn((1, 128, 128), generator=torch.Generator().manual_seed(3))
    fr, fi, br, bi, T0 = planes.backward_block(f, 0 * f, f, f, 2 * eye, eye,
                                               j, 14)
    assert torch.equal(fr, 2 * f) and torch.equal(br, f)
    spec = "axc,ayc->xy" if j == 1 else "acx,acy->xy"
    want = torch.einsum(spec, f, 2 * f)
    torch.testing.assert_close(T0, torch.complex(want, want), rtol=1e-5,
                               atol=1e-4)


def test_new_kernels_count_launches_and_refuse_meta():
    """The lane adjoint and the Q modes of the high and diag adjoints have
    launch counters (per mode for the Q modes) that the scan paths leave
    at 0, and never hand a tensor that lies neither on the CPU nor on a
    card to a plain version."""
    m = HardwareEfficientAnsatz(14, 2, entangler="cz", device="cpu")
    tk.reset_launch_counts()
    m.magnetization(torch.zeros(2, 14, 3, requires_grad=True)).backward()
    counts = tk.launch_counts()
    for key in ("block_backward_lane", "block_backward_high[diag_q]",
                "diag_backward[with_q]"):
        assert counts[key] == 0, (key, counts)
    x = torch.empty((1, 128, 128), device="meta")
    v = torch.empty((1, 128, 128, 128), device="meta")
    e = torch.empty((128, 128), device="meta")
    a = torch.empty((128, 128), device="meta")
    tabs = (a, a, x[0], x[0], x[0], x[0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_lane(x, x, x, x, e, e, e, e)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_high(v, v, v, v, e, e, e, e, diag_inv_tables=tabs,
                               diag_tables=tabs, diag_q=True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.diag_backward(x, x, x, x, *tabs, *tabs, with_q=True)
    assert tk.launch_counts() == counts


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


@pytest.mark.parametrize("make", [
    lambda: HardwareEfficientAnsatz(14, 3, "cz", device="cpu"),
    lambda: VQEIsing(14, 3, device="cpu"),
    lambda: QAOAMaxCut(14, [(i, i + 1) for i in range(13)], layers_number=3,
                       device="cpu"),
], ids=["hea", "vqe", "qaoa"])
def test_scan_models_build_no_unrolled_circuit(make):
    """Scan mode never builds or fuses the unrolled circuit; it is built on
    first use, with one var gate per ``params2gates`` entry."""
    m = make()
    assert "circuit" not in vars(m) and "_ftape" not in vars(m)
    p = m.init_params(torch.Generator().manual_seed(0))
    assert len(m.params2gates(p)) == m.circuit.tape.num_var_gates
    assert "circuit" in vars(m)


def test_singularity_checks_modes():
    """"host" refuses an ill-conditioned constant diagonal, "off" inverts
    it, and the JAX package's "debug" (a guard on variable gates, not
    ported) raises instead of acting like "host"."""
    from dqc_tpu_torch.ops import inversion
    bad = np.array([1.0, 1e-30], dtype=np.complex64)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            config.set_singularity_checks("debug")
        assert config.singularity_checks() == "host"
        with pytest.raises(ValueError, match="magnitude ratio"):
            inversion.invert_diag(bad, unitary=False)
        config.set_singularity_checks("off")
        assert np.isfinite(inversion.invert_diag(bad, unitary=False)).all()
        with pytest.raises(ValueError):
            config.set_singularity_checks("on")
    finally:
        config.set_singularity_checks("host")
    assert not hasattr(config, "set_full_unroll_qubits")


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
