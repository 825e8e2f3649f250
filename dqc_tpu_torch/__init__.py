"""dqc_tpu_torch — the PyTorch/CUDA port of dqc_tpu for NVIDIA Hopper.

A second package beside the JAX one (``dqc_tpu``), with the same module
names. It imports torch and numpy only, never JAX or ``dqc_tpu``. The
Pallas TPU kernels become hand-written CUDA kernels for ``sm_90a``
(``csrc/``, built with nvcc at first use); each has a plain PyTorch twin
that runs on CPU tensors. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.

So far: the reference-compatible ``AutoGradCircuit`` (``build()``'s
``simple_run`` and ``autodiff_run``, ``build_state_fn``) at any n and
dtype, on the plane engine and its kernels at n >= 14, complex64; ``GHZ``
and ``QFT``; the forward and the gradient (torch autograd) of
``HardwareEfficientAnsatz(n, L, entangler="cz" | "cnot")``, ``VQEIsing``
and ``QAOAMaxCut`` in scan mode at n in 14..30 and unrolled (``scan=False``)
at any n (ROADMAP.md lists what comes next).
"""

from dqc_tpu_torch.circuit.builder import AutoGradCircuit
from dqc_tpu_torch.models.ghz import GHZ
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz
from dqc_tpu_torch.models.qaoa import QAOAMaxCut
from dqc_tpu_torch.models.qft import QFT
from dqc_tpu_torch.models.vqe_ising import VQEIsing

__all__ = ["AutoGradCircuit", "GHZ", "HardwareEfficientAnsatz", "QAOAMaxCut",
           "QFT", "VQEIsing"]
