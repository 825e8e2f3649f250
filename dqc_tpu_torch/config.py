"""Runtime configuration for dqc_tpu_torch.

Counterpart of ``dqc_tpu/config.py``: the default complex dtype, gate
fusion, the plane-engine mode, the singularity checks of the uncompute, the
in-kernel dot modes (forward, cotangent side, pair grams), the state-plane
storage and the factorized merged-top sweep. The dot modes and the storage
have one ported value so far; asking for another raises
``NotImplementedError`` (ROADMAP.md lists the modes still to port).
The singularity checks' "debug" mode raises the same way. The JAX
package's matmul precision has no counterpart: the port never enables TF32,
so every product runs in full f32 (or f64). Neither has its
``set_full_unroll_qubits``, which picks a scanned or a straight-line
compiled program: the port compiles no program.

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

_FUSION = True
_PLANE_ENGINE = "auto"
_SINGULARITY_CHECKS = "host"

_KERNEL_DOT_MODE = "f32"
_STATE_STORAGE = "f32"
_BWD_KERNEL_DOT_MODE = "auto"
_GRAM_KERNEL_DOT_MODE = "auto"
_HPAIR_FACTORIZED = True


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
    """Validate a complex torch dtype argument (None -> the default)."""
    if dtype is None:
        return _DEFAULT_COMPLEX
    if dtype not in _REAL_OF:
        raise ValueError(f"expected complex64 or complex128, got {dtype}")
    return dtype


def set_default_complex(dtype) -> None:
    """Set the process-wide default complex dtype (complex64 or complex128)."""
    global _DEFAULT_COMPLEX
    if dtype not in _REAL_OF:
        raise ValueError(f"expected complex64 or complex128, got {dtype}")
    _DEFAULT_COMPLEX = dtype


def default_complex() -> torch.dtype:
    return _DEFAULT_COMPLEX


def set_fusion(enabled: bool) -> None:
    """Gate fusion (circuit/fusion.py): consecutive same-group gates compose
    into one full-group operator. On by default; ``AutoGradCircuit.build``
    reads it when ``fused`` is not given."""
    global _FUSION
    _FUSION = bool(enabled)


def default_fusion() -> bool:
    return _FUSION


def set_plane_engine(mode) -> None:
    """Plane-engine mode. ``False`` keeps every engine off the planes.
    ``True`` puts a plane-eligible tape (n >= 14, complex64) on the planes
    on any device, the CPU through the kernels' plain versions. ``"auto"``
    (the default) does the same in scan mode, and for
    ``AutoGradCircuit.build``'s ``autodiff_run`` picks the plane tape only
    when the state lives on a CUDA device; the JAX package's "auto" picks
    the planes on its TPU backend in both."""
    global _PLANE_ENGINE
    if mode not in (True, False, "auto"):
        raise ValueError("plane engine mode must be True, False or 'auto'")
    _PLANE_ENGINE = mode


def plane_engine():
    return _PLANE_ENGINE


def set_singularity_checks(mode: str) -> None:
    """"host" (the default) checks a constant non-unitary gate's inverse on
    the host and raises naming the gate; "off" skips the check. The JAX
    package's "debug" (a guard on traced gates) has no counterpart yet: a
    variable gate is not checked in the port (ops/inversion.py), so it
    raises."""
    global _SINGULARITY_CHECKS
    if mode == "debug":
        raise NotImplementedError(
            "singularity checks mode 'debug' (the guard on variable gates) is "
            "not ported to dqc_tpu_torch yet; see ROADMAP.md")
    if mode not in ("host", "off"):
        raise ValueError("singularity checks mode must be 'host', 'debug' or 'off'")
    _SINGULARITY_CHECKS = mode


def singularity_checks() -> str:
    return _SINGULARITY_CHECKS


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
    """The merged (top, top-1) sweep of a tiny top group: Kronecker-
    factorized (merged_fact_apply / block_backward_merged_fact, ``True``,
    the default as in the JAX package), or expanded (``False``): the merged
    operator ``Et (x) El`` applied on the X = 256 / 512 merged axis by the
    high apply in place and its adjoint by block_backward_high, the two
    blocks' pair grams extracted from the merged one."""
    global _HPAIR_FACTORIZED
    _HPAIR_FACTORIZED = bool(enabled)


def hpair_factorized() -> bool:
    return _HPAIR_FACTORIZED


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
