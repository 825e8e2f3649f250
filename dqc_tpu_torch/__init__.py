"""dqc_tpu_torch — the PyTorch/CUDA port of dqc_tpu for NVIDIA Hopper.

A second package beside the JAX one (``dqc_tpu``), with the same module
names. It imports torch and numpy only, never JAX or ``dqc_tpu``. The
Pallas TPU kernels become hand-written CUDA kernels for ``sm_90a``
(``csrc/``, built with nvcc at first use); each has a plain PyTorch twin
that runs on CPU tensors. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.

So far: the forward and the gradient (torch autograd) of
``HardwareEfficientAnsatz(n, L, entangler="cz")`` at n in {14, 17..21,
24..28} (ROADMAP.md lists what comes next).
"""

from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz

__all__ = ["HardwareEfficientAnsatz"]
