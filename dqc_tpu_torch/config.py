"""Runtime configuration for dqc_tpu_torch (the forward subset).

Counterpart of ``dqc_tpu/config.py``. Only the settings the plane-engine
forward reads are kept: the complex dtype, the in-kernel dot mode and the
state-plane storage. Each has one ported value so far; asking for another
raises ``NotImplementedError`` (ROADMAP.md lists the modes still to port).

``resolve_device`` is the port's device rule: every public entry point takes
``device=None``, which means the CUDA card; without one it raises.
"""

from __future__ import annotations

import torch

_DEFAULT_COMPLEX = torch.complex64

_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
}

_KERNEL_DOT_MODE = "f32"
_STATE_STORAGE = "f32"


def _not_ported(what: str, value) -> NotImplementedError:
    return NotImplementedError(
        f"{what} {value!r} is not ported to dqc_tpu_torch yet (only 'f32'); "
        "see ROADMAP.md")


def canonicalize_complex(dtype=None) -> torch.dtype:
    """Validate a complex torch dtype argument (None -> complex64)."""
    if dtype is None:
        return _DEFAULT_COMPLEX
    if dtype not in _REAL_OF:
        raise ValueError(f"expected complex64 or complex128, got {dtype}")
    return dtype


def real_of(dtype) -> torch.dtype:
    """The real dtype matching a complex dtype (c64 -> f32, c128 -> f64)."""
    return _REAL_OF[canonicalize_complex(dtype)]


def set_kernel_dot_mode(mode: str) -> None:
    if mode != "f32":
        raise _not_ported("kernel dot mode", mode)


def kernel_dot_mode() -> str:
    """In-kernel product mode: "f32" is f32 FMA on the CUDA cores (no TF32)."""
    return _KERNEL_DOT_MODE


def set_state_storage(mode: str) -> None:
    if mode != "f32":
        raise _not_ported("state storage", mode)


def state_storage() -> str:
    return _STATE_STORAGE


def fwd_plane_dtype() -> torch.dtype:
    """Storage dtype of the forward statevector planes."""
    return torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is no card.
    An explicit device (``"cpu"`` in the tests) is returned as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dqc_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
