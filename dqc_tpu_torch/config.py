"""Runtime configuration for dqc_tpu_torch.

Counterpart of ``dqc_tpu/config.py``: the default complex dtype, gate
fusion, the plane-engine mode, the singularity checks of the uncompute, the
in-kernel dot modes (forward, cotangent side, pair grams), the state-plane
storage and the factorized merged-top sweep. Every storage ("f32",
"mixed", "f16", "bf16") and both dot modes ("f32", "bf16x3") of the JAX
package are accepted and run on every plane path the JAX package runs
them on: the cz and CNOT rings at every size (n = 14-30), the expanded
merged top, VQEIsing, QAOAMaxCut and ``autodiff_run``'s plane tape, with
"f16" on the per-term fallback of a dense cross-group gate too. The
singularity checks' "debug" mode raises ``NotImplementedError`` naming
ROADMAP.md. The JAX
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


def _backward_mode(what: str, mode: str) -> str:
    if mode not in ("auto", "f32", "bf16x3"):
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
    """The forward products: every apply, every Gram, every seed and the
    uncompute of every adjoint, and what the backward "auto" resolves to
    under f32 storage. "f32" (the default) or "bf16x3", the JAX package's
    opt-in 3-pass split (common.cuh: two FMAs per real product on the CUDA
    cores). Every kernel takes "bf16x3": the cz and CNOT rings, the
    expanded merged top, VQEIsing, QAOAMaxCut and ``autodiff_run``'s plane
    tape run under it."""
    global _KERNEL_DOT_MODE
    if mode not in ("f32", "bf16x3"):
        raise ValueError("kernel dot mode must be 'f32' or 'bf16x3'")
    _KERNEL_DOT_MODE = mode


def kernel_dot_mode() -> str:
    """In-kernel forward product mode: "f32" is f32 FMA on the CUDA cores
    (no TF32), "bf16x3" the 3-pass split."""
    return _KERNEL_DOT_MODE


def set_bwd_kernel_dot_mode(mode: str) -> None:
    """Dot mode of the cotangent-side contractions of the backward kernels
    (transport ``b' = E^T b``): "auto", "f32" or "bf16x3"."""
    global _BWD_KERNEL_DOT_MODE
    _BWD_KERNEL_DOT_MODE = _backward_mode("bwd kernel dot mode", mode)


def bwd_kernel_dot_mode() -> str:
    """"auto" is "bf16x3" under reduced cotangent storage ("mixed", "f16",
    "bf16": its dot error sits far under the per-store rounding) and the
    forward mode (``kernel_dot_mode``) under "f32", as in the JAX
    package."""
    if _BWD_KERNEL_DOT_MODE == "auto":
        if _STATE_STORAGE in ("mixed", "f16", "bf16"):
            return "bf16x3"
        return kernel_dot_mode()
    return _BWD_KERNEL_DOT_MODE


def set_gram_kernel_dot_mode(mode: str) -> None:
    """Dot mode of the pair grams ``T0`` inside the backward kernels:
    "auto", "f32" or "bf16x3"."""
    global _GRAM_KERNEL_DOT_MODE
    _GRAM_KERNEL_DOT_MODE = _backward_mode("gram kernel dot mode", mode)


def gram_kernel_dot_mode() -> str:
    """"auto" resolves to "bf16x3" whatever the storage, as in the JAX
    package: each pair gram is a per-gate leaf output, so its 3-pass split
    does not compound."""
    if _GRAM_KERNEL_DOT_MODE == "auto":
        return "bf16x3"
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
    """Storage of the statevector planes between kernel passes (compute is
    f32 inside the kernels): "f32"; "mixed", forward planes f32 and
    cotangent planes bf16; "f16", cotangent planes float16, carrying the
    power-of-2 prescale of plane_scan._ct_prescale; "bf16", both pairs
    bfloat16 (the value carries bf16 rounding too). Every storage runs on
    every plane path: the cz and CNOT rings at every size, the expanded
    merged top, VQEIsing, QAOAMaxCut and ``autodiff_run``'s plane tape;
    under "f16" the per-term fallback of a dense cross-group gate hands the
    f16 cotangent to the dual and high applies as their input. Off the
    planes (n < 14, complex128, the plane engine off) the storage has no
    effect."""
    global _STATE_STORAGE
    if mode not in ("f32", "mixed", "f16", "bf16"):
        raise ValueError("state storage must be 'f32', 'mixed', 'f16' or 'bf16'")
    _STATE_STORAGE = mode


def state_storage() -> str:
    return _STATE_STORAGE


def fwd_plane_dtype() -> torch.dtype:
    """Storage dtype of the forward statevector planes: bfloat16 under
    "bf16", else float32."""
    return torch.bfloat16 if _STATE_STORAGE == "bf16" else torch.float32


def bwd_plane_dtype() -> torch.dtype:
    """Storage dtype of the cotangent planes: bfloat16 under "mixed" and
    "bf16", float16 under "f16" (the JAX package keeps the same bits in
    uint16 planes because Mosaic has no f16 type), else float32."""
    return {"mixed": torch.bfloat16, "bf16": torch.bfloat16,
            "f16": torch.float16}.get(
        _STATE_STORAGE, torch.float32)


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
