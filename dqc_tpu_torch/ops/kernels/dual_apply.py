"""Dual-group apply on f32 planes: ``y = Em . X . El^T`` per 128x128 slab.

Replaces the TPU kernel ``dual_group_apply_planes``
(``dqc_tpu/ops/pallas/dual_apply.py:232``): the lane-group operator ``El``
(qubits 0..6) and sublane-group operator ``Em`` (qubits 7..13) on planes
``(A, 128, 128) x 2`` in one pass, with an optional fused diagonal run
``D[a,s,l] = tas[a,s] tal[a,l] tsl[s,l]`` multiplied before
(``diag_first``) or after the products, and the density-seed modes of the
gradient: ``conj`` writes ``conj(y)``, ``acc`` adds ``y`` into accumulator
planes, ``alias=False`` writes fresh planes and leaves the input intact.
The Hopper kernel is ``csrc/dual_apply.cu`` (bound by operations: 256
complex multiply-adds per amplitude against 16 bytes);
:func:`dual_apply_plain` is its plain PyTorch version.

:func:`dual_apply` consumes its input planes unless ``alias=False`` or
``acc`` is given: on a CUDA tensor the kernel writes the result into them
(as the TPU kernel aliases output to input), into the accumulator planes
with ``acc``, or into fresh planes with ``alias=False``; on a CPU tensor it
returns the plain version's fresh planes. Callers use the returned planes.

The seed's output planes may be stored reduced, the cotangent storage of
``config.set_state_storage`` (``out_dtype``, or the accumulator's dtype):
bfloat16 or float16 in the kernels' codec (ops/kernels/_storage.py). Those
launches are also counted in ``mode_launches`` under the storage's name
("bf16", "f16"). The input planes are float32 or bfloat16 (the forward
planes under "bf16" storage: in place on them, or a seed from them into
bf16 cotangent planes), or float16 into planes of their storage (the
cotangent under "f16", which the per-term fallback of a dense cross-group
gate hands the kernel as its input; decoded as the TPU kernel's
``f32_of`` decodes its uint16 planes), and the two products run in
``dot_mode`` ("f32", or "bf16x3" as ``dots.make_dot``; the TPU kernel's
``dot_mode``), counted as "fwd_bf16" and "fwd_bf16x3"; float16 input is
counted as "in_f16".
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st

Planes = Tuple[torch.Tensor, torch.Tensor]


def diag_run(diag_tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """Complex ``D[a, s, l] = (tas[a,s] tal[a,l]) tsl[s,l]``, shape (A, 128, 128)."""
    tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i = diag_tables
    tas = torch.complex(tas_r, tas_i)
    tal = torch.complex(tal_r, tal_i)
    tsl = torch.complex(tsl_r, tsl_i)
    return (tas[:, :, None] * tal[:, None, :]) * tsl[None]


def dual_apply_plain(xr, xi, el_r, el_i, em_r, em_i,
                     diag_tables: Optional[Sequence[torch.Tensor]] = None,
                     diag_first: bool = True, *, conj: bool = False,
                     acc: Optional[Planes] = None, alias: bool = True,
                     out_dtype=None, dot_mode: str = "f32") -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmuls in
    ``dot_mode``, the planes decoded and encoded as the kernel does); fresh
    outputs, whatever ``alias`` says."""
    x = _st.load_b(xr, xi)
    D = diag_run(diag_tables) if diag_tables is not None else None
    if D is not None and diag_first:
        x = x * D
    el = torch.complex(el_r, el_i)
    em = torch.complex(em_r, em_i)
    y = _st.cmatmul(em, _st.cmatmul(x, el.transpose(0, 1), dot_mode), dot_mode)
    if D is not None and not diag_first:
        y = y * D
    return _st.seed_out(y.real, y.imag, conj, acc, out_dtype or xr.dtype)


_ARGTYPES = ([_launch.VOIDP] * 4 + [_launch.INT] * 2 + [_launch.VOIDP] * 10
             + [_launch.INT] * 5 + [_launch.LONG, _launch.VOIDP])


def dual_apply(xr, xi, el_r, el_i, em_r, em_i,
               diag_tables: Optional[Sequence[torch.Tensor]] = None,
               diag_first: bool = True, *, conj: bool = False,
               acc: Optional[Planes] = None, alias: bool = True,
               out_dtype=None, dot_mode: str = "f32") -> Planes:
    """``[acc +] conj?([D] Em X El^T [D])`` on planes ``(A, 128, 128)``
    stored as float32, bfloat16 or float16; operators are f32 real/imag pairs (128,
    128); ``diag_tables`` the run's six f32 planes ``(tsl_r, tsl_i, tas_r,
    tas_i, tal_r, tal_i)`` or None. ``out_dtype``: the storage of fresh
    output planes (``alias=False``); ``dot_mode``: the products' dot
    mode."""
    if xr.dim() != 3 or tuple(xr.shape[1:]) != (128, 128) or xi.shape != xr.shape:
        raise ValueError(f"dual_apply: planes must be (A, 128, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    _st.check_fwd("dual_apply", xr, xi, dot_mode, f16=True)
    seed = acc is not None or not alias
    if seed:
        _st.check_apply_storage("dual_apply", xr.dtype, (
            acc[0].dtype if acc is not None else out_dtype or xr.dtype))
    if xr.device.type == "cpu":
        return dual_apply_plain(xr, xi, el_r, el_i, em_r, em_i, diag_tables,
                                diag_first, conj=conj, acc=acc,
                                out_dtype=out_dtype, dot_mode=dot_mode)
    A = xr.shape[0]
    ops = (el_r, el_i, em_r, em_i)
    _launch.check_cuda_f32("dual_apply", (xr, xi), xr.device, align=16,
                           dtypes=_st.STORAGE_DTYPES)
    out = _launch.output_planes("dual_apply", xr, xi, acc, alias, out_dtype,
                                _st.STORAGE_DTYPES)
    _launch.check_cuda_f32("dual_apply", ops, xr.device)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("dual_apply: operators must be (128, 128)")
    _launch.check_tables("dual_apply", diag_tables, A, xr.device)
    fn = _launch.entry("dual_apply", "dqc_dual_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
              _st.storage_kind(xr.dtype), _st.storage_kind(out[0].dtype),
              *(o.data_ptr() for o in ops), *_launch.table_ptrs(diag_tables),
              int(diag_tables is not None), int(diag_first), int(conj),
              int(acc is not None), int(dot_mode == "bf16x3"), A,
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "dual_apply", "dual_apply launch")
    dual_apply.launches += 1
    if seed:
        _st.count_storage(dual_apply, out[0].dtype)
    _st.count_fwd(dual_apply, xr.dtype, dot_mode)
    if xr.dtype == torch.float16:
        dual_apply.mode_launches["in_f16"] += 1
    return out


dual_apply.launches = 0
dual_apply.mode_launches = {"in_f16": 0, "bf16": 0, "f16": 0, "fwd_bf16": 0,
                            "fwd_bf16x3": 0}
