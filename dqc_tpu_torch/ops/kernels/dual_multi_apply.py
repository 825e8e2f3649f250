"""Multi-term dual-group apply on the planes: ``y = sum_t Em_t . X . El_t^T``.

Replaces the TPU kernel ``dual_multi_apply_planes``
(``dqc_tpu/ops/pallas/dual_apply.py:165``): a dense gate across the lane
group (qubits 0..6) and the sublane group (7..13) as the T terms of its
decomposition (``El_t`` on the last axis, ``Em_t`` on the middle one, each
128 x 128), on planes ``(A, 128, 128) x 2`` in one pass, with the
density-seed modes of the gradient (the seed of a density across the two
groups): ``conj`` writes ``conj(y)``, ``acc`` adds ``y`` into accumulator
planes, ``alias=False`` writes fresh planes and leaves the input intact.
The Hopper kernel is ``csrc/dual_multi_apply.cu``, every product on the
tensor cores (3xTF32 in the "f32" dot mode, three bf16 products in bf16x3;
bound by operations: 256 T complex multiply-adds per amplitude against 16
bytes, 13.33 ms at T = 2 on 2^29 f32 amplitudes), handed the stacked
factors pre-split in mma fragment order (:func:`operators`), any T (16 for
a traced k >= 4 gate); every launch counts in ``mode_launches["tc"]``.
:func:`dual_multi_apply_plain` is its plain PyTorch version.

:func:`dual_multi_apply` consumes its input planes unless ``alias=False``
or ``acc`` is given: on a CUDA tensor the kernel writes the result into
them, into the accumulator planes with ``acc``, or into fresh planes with
``alias=False``; on a CPU tensor it returns the plain version's fresh
planes. Callers use the returned planes.

Under reduced cotangent storage (``config.set_state_storage``) the planes
may be stored as bfloat16 or float16 in the kernels' codec
(ops/kernels/_storage.py), as the TPU kernel's ``f32_of`` / ``store_as``:
in place on reduced planes (the transport of a cross-group gate on the
cotangent), or a seed from f32 planes into reduced ones (``acc``'s dtype or
``out_dtype``). Those launches are also counted in ``mode_launches`` under
the storage's name ("bf16", "f16"). Under "bf16" storage the forward planes
are bfloat16 too: in place on them (the uncompute; counted as "bf16", as
in place on a bfloat16 cotangent) and the seeds from them into bfloat16
cotangent planes (counted as "fwd_bf16"); the products may run bf16x3
(``dot_mode``, the forward bf16x3), counted as "fwd_bf16x3".
"""

from __future__ import annotations

from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels import _tc

Planes = Tuple[torch.Tensor, torch.Tensor]


def dual_multi_apply_plain(xr, xi, el_r, el_i, em_r, em_i, *,
                           conj: bool = False, acc=None, alias: bool = True,
                           out_dtype=None, dot_mode: str = "f32") -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmuls in
    ``dot_mode``, one term at a time, the lane product first, the planes
    decoded and encoded as the kernel does); fresh outputs in the kernel's
    storage, whatever ``alias`` says."""
    x = _st.load_b(xr, xi)
    el = torch.complex(el_r, el_i)
    em = torch.complex(em_r, em_i)
    y = None
    for t in range(el.shape[0]):
        yt = _st.cmatmul(em[t], _st.cmatmul(x, el[t].transpose(0, 1), dot_mode),
                         dot_mode)
        y = yt if y is None else y + yt
    return _st.seed_out(y.real, y.imag, conj, acc, out_dtype or xr.dtype)


# x, y, kinds, x3, El_t and Em_t pre-split, El_t in three parts, T, conj,
# has_acc, A, stream
_ARGTYPES = ([_launch.VOIDP] * 4 + [_launch.INT] * 3 + [_launch.VOIDP] * 2
             + [_launch.INT] * 4 + [_launch.LONG, _launch.VOIDP])


def operators(el_r, el_i, em_r, em_i, dot_mode: str, x_dtype):
    """The stacked factors as ``csrc/dual_multi_apply.cu`` reads them
    (``_tc.tc_operator`` of each stack, each the ``Op`` of its ``Op x tile``
    product): El_t for the lane products on x stored as ``x_dtype`` (in
    three tf32 parts where 3xTF32 meets 16-bit x), Em_t for the sublane
    products on the f32 T (or the high multi-term apply's E_t, X x X, for
    its group products; X = 8 laid out as ``diag(E_t, E_t)``)."""
    return (_tc.tc_operator(el_r, el_i, dot_mode, _tc.operator_parts(dot_mode, x_dtype)),
            _tc.tc_operator(em_r, em_i, dot_mode))


def check_terms(what: str, ops, T: int, shape) -> None:
    if any(tuple(o.shape) != (T, *shape) for o in ops):
        raise ValueError(f"{what}: stacked factors must be {(T, *shape)}, got "
                         f"{[tuple(o.shape) for o in ops]}")


def out_storage(xr, acc, alias: bool, out_dtype):
    """The storage an apply writes: the accumulator's, the input's (in
    place) or ``out_dtype`` (fresh planes; the input's when None)."""
    if acc is not None:
        return acc[0].dtype
    if alias:
        return xr.dtype
    return out_dtype or xr.dtype


def count_modes(wrapper, xdtype, ydtype, seed: bool, dot_mode: str) -> None:
    """A multi-term apply's counted modes: "seed"; its output planes'
    reduced storage; a seed from bfloat16 forward planes ("bf16" storage;
    a seed reads the forward planes) as "fwd_bf16"; the forward bf16x3 as
    "fwd_bf16x3". In place, bfloat16 planes count as "bf16" whether they are
    the cotangent or the forward planes."""
    if seed:
        wrapper.mode_launches["seed"] += 1
    _st.count_storage(wrapper, ydtype)
    _st.count_fwd(wrapper, xdtype if seed else torch.float32, dot_mode)


def dual_multi_apply(xr, xi, el_r, el_i, em_r, em_i, *, conj: bool = False,
                     acc=None, alias: bool = True, out_dtype=None,
                     dot_mode: str = "f32") -> Planes:
    """``[acc +] conj?(sum_t Em_t X El_t^T)`` on planes ``(A, 128, 128)``;
    the factors are f32 real/imag planes stacked ``(T, 128, 128)``.
    ``out_dtype``: the storage of fresh output planes (``alias=False``);
    ``dot_mode``: the products' (the forward dot mode)."""
    if xr.dim() != 3 or tuple(xr.shape[1:]) != (128, 128) or xi.shape != xr.shape:
        raise ValueError(f"dual_multi_apply: planes must be (A, 128, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    ops = (el_r, el_i, em_r, em_i)
    T = el_r.shape[0] if el_r.dim() == 3 else 0
    if T < 1:
        raise ValueError("dual_multi_apply: factors must be stacked (T, 128, 128)")
    check_terms("dual_multi_apply", ops, T, (128, 128))
    _st.check_apply_storage("dual_multi_apply", xr.dtype,
                            out_storage(xr, acc, alias, out_dtype))
    _st.check_dot_mode("dual_multi_apply", dot_mode)
    if xr.device.type == "cpu":
        return dual_multi_apply_plain(xr, xi, *ops, conj=conj, acc=acc,
                                      out_dtype=None if alias else out_dtype,
                                      dot_mode=dot_mode)
    _launch.check_cuda_f32("dual_multi_apply", (xr, xi), xr.device, align=16,
                           dtypes=_st.STORAGE_DTYPES)
    out = _launch.output_planes("dual_multi_apply", xr, xi, acc, alias,
                                out_dtype, _st.STORAGE_DTYPES)
    _launch.check_cuda_f32("dual_multi_apply", ops, xr.device)
    op_l, op_m = operators(*ops, dot_mode, xr.dtype)
    fn = _launch.entry("dual_multi_apply", "dqc_dual_multi_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
              _st.storage_kind(xr.dtype), _st.storage_kind(out[0].dtype),
              int(dot_mode == "bf16x3"), op_l.data_ptr(), op_m.data_ptr(),
              int(op_l.shape[3] == 6), T, int(conj), int(acc is not None), xr.shape[0],
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "dual_multi_apply", "dual_multi_apply launch")
    dual_multi_apply.launches += 1
    dual_multi_apply.mode_launches["tc"] += 1
    count_modes(dual_multi_apply, xr.dtype, out[0].dtype,
                conj or acc is not None or not alias, dot_mode)
    return out


dual_multi_apply.launches = 0
dual_multi_apply.mode_launches = {"tc": 0, "seed": 0, "bf16": 0, "f16": 0,
                                  "fwd_bf16": 0, "fwd_bf16x3": 0}
