"""Runtime configuration for dqc_tpu_torch (the plane-engine subset).

Counterpart of ``dqc_tpu/config.py``. Only the settings the plane engine
reads are kept: the complex dtype, the in-kernel dot modes (forward,
cotangent side, pair grams), the state-plane storage and the factorized
merged-top sweep. Each has one
ported value so far; asking for another raises ``NotImplementedError``
(ROADMAP.md lists the modes still to port).

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
_BWD_KERNEL_DOT_MODE = "auto"
_GRAM_KERNEL_DOT_MODE = "auto"


def _not_ported(what: str, value) -> NotImplementedError:
    return NotImplementedError(
        f"{what} {value!r} is not ported to dqc_tpu_torch yet (only 'f32'); "
        "see ROADMAP.md")


def _backward_mode(what: str, mode: str) -> str:
    if mode == "bf16x3":
        raise NotImplementedError(
            f"{what} 'bf16x3' (the 3-pass bf16 split of dots.make_dot) is not "
            "ported to dqc_tpu_torch yet; see ROADMAP.md slice 4")
    if mode not in ("auto", "f32"):
        raise ValueError(f"{what} must be 'auto', 'f32' or 'bf16x3'")
    return mode


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


def set_bwd_kernel_dot_mode(mode: str) -> None:
    """Dot mode of the cotangent-side contractions of the backward kernels
    (transport ``b' = E^T b``)."""
    global _BWD_KERNEL_DOT_MODE
    _BWD_KERNEL_DOT_MODE = _backward_mode("bwd kernel dot mode", mode)


def bwd_kernel_dot_mode() -> str:
    """"auto" follows the forward mode; with f32 storage, the only ported
    one, that is the JAX package's resolution too."""
    if _BWD_KERNEL_DOT_MODE == "auto":
        return kernel_dot_mode()
    return _BWD_KERNEL_DOT_MODE


def set_gram_kernel_dot_mode(mode: str) -> None:
    """Dot mode of the pair grams ``T0`` inside the backward kernels."""
    global _GRAM_KERNEL_DOT_MODE
    _GRAM_KERNEL_DOT_MODE = _backward_mode("gram kernel dot mode", mode)


def gram_kernel_dot_mode() -> str:
    """"auto" resolves to "f32" until bf16x3 is ported. The JAX package
    resolves it to "bf16x3" (ROADMAP.md section C records the difference)."""
    if _GRAM_KERNEL_DOT_MODE == "auto":
        return "f32"
    return _GRAM_KERNEL_DOT_MODE


def set_hpair_factorized(enabled: bool) -> None:
    """The merged (top, top-1) sweep of a tiny top group runs Kronecker-
    factorized (merged_fact_apply / block_backward_merged_fact), the JAX
    package's default. The expanded merged sweep (``False``) needs the high
    backward kernel at X = 256 / 512 and is not ported."""
    if not enabled:
        raise NotImplementedError(
            "the expanded merged-top sweep (set_hpair_factorized(False)) needs "
            "block_backward_high at X = 256 / 512, not ported to dqc_tpu_torch "
            "yet; see ROADMAP.md")


def hpair_factorized() -> bool:
    return True


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
