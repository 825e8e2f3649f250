"""Multi-term dual-group apply on f32 planes: ``y = sum_t Em_t . X . El_t^T``.

Replaces the TPU kernel ``dual_multi_apply_planes``
(``dqc_tpu/ops/pallas/dual_apply.py:165``) in its in-place form: a dense
gate across the lane group (qubits 0..6) and the sublane group (7..13) as
the T terms of its decomposition (``El_t`` on the last axis, ``Em_t`` on
the middle one, each 128 x 128), on planes ``(A, 128, 128) x 2`` in one
pass. The density-seed modes of the TPU kernel (``conj``, ``acc``,
``alias=False``: the cross-group density seed) are not ported and raise
``NotImplementedError`` on any device. The Hopper kernel is
``csrc/dual_multi_apply.cu`` on ``csrc/multi_apply.cuh`` (bound by
operations: 256 T complex multiply-adds per amplitude against 16 bytes);
:func:`dual_multi_apply_plain` is its plain PyTorch version.

:func:`dual_multi_apply` consumes its input planes: on a CUDA tensor the
kernel writes the result into them; on a CPU tensor it returns the plain
version's fresh planes. Callers use the returned planes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch

Planes = Tuple[torch.Tensor, torch.Tensor]


def check_in_place(what: str, conj: bool, acc, alias: bool) -> None:
    """The multi-term kernels run in place only: the seed modes raise."""
    if conj or acc is not None or not alias:
        raise NotImplementedError(
            f"{what}: the conj / acc / alias=False modes (the cross-group "
            "density seed) are not ported to dqc_tpu_torch yet; see ROADMAP.md")


def dual_multi_apply_plain(xr, xi, el_r, el_i, em_r, em_i, *,
                           conj: bool = False, acc=None,
                           alias: bool = True) -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmuls, one term at a
    time); fresh outputs. The seed modes raise, as in the kernel."""
    check_in_place("dual_multi_apply_planes", conj, acc, alias)
    x = torch.complex(xr, xi)
    el = torch.complex(el_r, el_i)
    em = torch.complex(em_r, em_i)
    y = None
    for t in range(el.shape[0]):
        yt = torch.matmul(em[t], torch.matmul(x, el[t].transpose(0, 1)))
        y = yt if y is None else y + yt
    return y.real.contiguous(), y.imag.contiguous()


_ARGTYPES = [_launch.VOIDP] * 6 + [_launch.INT, _launch.LONG, _launch.VOIDP]


def check_terms(what: str, ops, T: int, shape) -> None:
    if any(tuple(o.shape) != (T, *shape) for o in ops):
        raise ValueError(f"{what}: stacked factors must be {(T, *shape)}, got "
                         f"{[tuple(o.shape) for o in ops]}")


def dual_multi_apply(xr, xi, el_r, el_i, em_r, em_i, *, conj: bool = False,
                     acc=None, alias: bool = True) -> Planes:
    """``sum_t Em_t X El_t^T`` on planes ``(A, 128, 128)``, in place; the
    factors are f32 real/imag planes stacked ``(T, 128, 128)``."""
    check_in_place("dual_multi_apply_planes", conj, acc, alias)
    if xr.dim() != 3 or tuple(xr.shape[1:]) != (128, 128) or xi.shape != xr.shape:
        raise ValueError(f"dual_multi_apply: planes must be (A, 128, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    ops = (el_r, el_i, em_r, em_i)
    T = el_r.shape[0] if el_r.dim() == 3 else 0
    if T < 1:
        raise ValueError("dual_multi_apply: factors must be stacked (T, 128, 128)")
    check_terms("dual_multi_apply", ops, T, (128, 128))
    if xr.device.type == "cpu":
        return dual_multi_apply_plain(xr, xi, *ops)
    _launch.check_cuda_f32("dual_multi_apply", (xr, xi), xr.device, align=16)
    _launch.check_cuda_f32("dual_multi_apply", ops, xr.device)
    # the kernel reads the factors transposed, so that its tile loads coalesce
    elt_r, elt_i, emt_r, emt_i = (o.transpose(1, 2).contiguous() for o in ops)
    fn = _launch.entry("dual_multi_apply", "dqc_dual_multi_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), elt_r.data_ptr(), elt_i.data_ptr(),
              emt_r.data_ptr(), emt_i.data_ptr(), T, xr.shape[0],
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "dual_multi_apply", "dual_multi_apply launch")
    dual_multi_apply.launches += 1
    return xr, xi


dual_multi_apply.launches = 0
