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
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch

Planes = Tuple[torch.Tensor, torch.Tensor]


def diag_run(diag_tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """Complex ``D[a, s, l] = (tas[a,s] tal[a,l]) tsl[s,l]``, shape (A, 128, 128)."""
    tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i = diag_tables
    tas = torch.complex(tas_r, tas_i)
    tal = torch.complex(tal_r, tal_i)
    tsl = torch.complex(tsl_r, tsl_i)
    return (tas[:, :, None] * tal[:, None, :]) * tsl[None]


def _seed_out(yr, yi, conj: bool, acc) -> Planes:
    """The seed modes on a complex result: ``[acc +] conj?(y)``."""
    if conj:
        yi = -yi
    if acc is not None:
        yr, yi = acc[0] + yr, acc[1] + yi
    return yr.contiguous(), yi.contiguous()


def dual_apply_plain(xr, xi, el_r, el_i, em_r, em_i,
                     diag_tables: Optional[Sequence[torch.Tensor]] = None,
                     diag_first: bool = True, *, conj: bool = False,
                     acc: Optional[Planes] = None, alias: bool = True) -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmuls); fresh
    outputs, whatever ``alias`` says."""
    x = torch.complex(xr, xi)
    D = diag_run(diag_tables) if diag_tables is not None else None
    if D is not None and diag_first:
        x = x * D
    el = torch.complex(el_r, el_i)
    em = torch.complex(em_r, em_i)
    y = torch.matmul(em, torch.matmul(x, el.transpose(0, 1)))
    if D is not None and not diag_first:
        y = y * D
    return _seed_out(y.real, y.imag, conj, acc)


_ARGTYPES = [_launch.VOIDP] * 14 + [_launch.INT] * 4 + [_launch.LONG,
                                                        _launch.VOIDP]


def dual_apply(xr, xi, el_r, el_i, em_r, em_i,
               diag_tables: Optional[Sequence[torch.Tensor]] = None,
               diag_first: bool = True, *, conj: bool = False,
               acc: Optional[Planes] = None, alias: bool = True) -> Planes:
    """``[acc +] conj?([D] Em X El^T [D])`` on planes ``(A, 128, 128)``;
    operators are f32 real/imag pairs (128, 128); ``diag_tables`` the run's
    six f32 planes ``(tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)`` or None."""
    if xr.dim() != 3 or tuple(xr.shape[1:]) != (128, 128) or xi.shape != xr.shape:
        raise ValueError(f"dual_apply: planes must be (A, 128, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if xr.device.type == "cpu":
        return dual_apply_plain(xr, xi, el_r, el_i, em_r, em_i, diag_tables,
                                diag_first, conj=conj, acc=acc)
    A = xr.shape[0]
    ops = (el_r, el_i, em_r, em_i)
    _launch.check_cuda_f32("dual_apply", (xr, xi), xr.device, align=16)
    out = _launch.output_planes("dual_apply", xr, xi, acc, alias)
    _launch.check_cuda_f32("dual_apply", ops, xr.device)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("dual_apply: operators must be (128, 128)")
    _launch.check_tables("dual_apply", diag_tables, A, xr.device)
    fn = _launch.entry("dual_apply", "dqc_dual_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
              *(o.data_ptr() for o in ops), *_launch.table_ptrs(diag_tables),
              int(diag_tables is not None), int(diag_first), int(conj),
              int(acc is not None), A, _launch.stream(xr.device))
    _launch.raise_on_error(code, "dual_apply", "dual_apply launch")
    dual_apply.launches += 1
    return out


dual_apply.launches = 0
