"""The in-kernel storage codec and the bf16x3 dots of the plain versions.

Counterparts of ``dqc_tpu/ops/pallas/common.py`` ``f32_of`` / ``store_as``
(the cotangent planes' codec at every kernel load and store) and of
``dqc_tpu/ops/pallas/dots.py`` ``_dot_bf16x3`` (the 3-pass split of the
backward kernels' cotangent-side products), as the kernels' plain PyTorch
versions use them; ``csrc/common.cuh`` holds the kernels' copies.

The cotangent planes are stored as float32, bfloat16 or float16. The
bfloat16 codec is a round-to-nearest-even downcast. The float16 codec is
the JAX package's, which is not IEEE half conversion: the encode clamps to
±65504 and stores every |x| < 2^-14 (the f16 subnormal band) as a signed
zero, rounding to nearest even elsewhere; the decode reads every subnormal
pattern as a signed zero and an exponent of 31 (inf and NaN patterns) as
2^16 (1 + m / 1024). Host-side conversions outside the kernels
(``ops/planes.plane_store``) stay IEEE, as the JAX package's are.

``bf16x3``: ``hi = bf16(a)``, ``lo = bf16(a - hi)`` and ``a b ~ ah bh +
ah bl + al bh`` accumulated in f32. ``ah (bh + bl) + al bh`` is the same
sum: every product of those parts is exact in f32 (``bh + bl`` has at most
16 significant bits), so only the f32 accumulation rounds.

The forward planes are stored as float32 or bfloat16 ("bf16" storage),
with the same codec; the forward products (the applies, the Grams, the
seeds and the adjoints' uncompute) run in the forward dot mode
(``config.kernel_dot_mode``).

Beside them: the planes' load, round and store in the plain versions, the
wrappers' mode checks, ``mode_launches`` counters and refusals (a kernel
without a storage or dot mode raises, never falls back to f32), and the
yardsticks the kernels are held to under reduced storage (``ulps_apart``,
``gram_tolerance``).
"""

from __future__ import annotations

from typing import Tuple

import torch

STORAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
FWD_DTYPES = (torch.float32, torch.bfloat16)   # the forward planes' storages
DOT_MODES = ("f32", "bf16x3")
# where the float16 input planes that the Grams, the merged-top apply and
# the diagonal sweep do not take yet are listed (no path hands them one)
NOT_PORTED_F16 = "see ROADMAP.md, queue B item 1"
_F16_MIN_NORMAL = 2.0 ** -14
_F16_MAX = 65504.0


def storage_kind(dtype: torch.dtype) -> int:
    """The kernels' storage code of a plane dtype: 0 float32, 1 bfloat16,
    2 float16."""
    try:
        return STORAGE_DTYPES.index(dtype)
    except ValueError:
        raise TypeError(f"plane storage {dtype} is not one of "
                        f"{STORAGE_DTYPES}") from None


def storage_name(dtype: torch.dtype) -> str:
    return ("f32", "bf16", "f16")[storage_kind(dtype)]


def check_dot_mode(what: str, mode: str) -> None:
    if mode not in DOT_MODES:
        raise ValueError(f"{what}: dot mode must be one of {DOT_MODES}, got {mode!r}")


def f32_of(x: torch.Tensor) -> torch.Tensor:
    """Kernel load: a stored plane as float32 values."""
    if x.dtype == torch.float16:
        v = x.to(torch.float32)
        bits = x.view(torch.int16)
        exp = (bits >> 10) & 0x1F
        # exponent 31: the codec's 2^16 (1 + m / 1024), sign kept
        big = torch.copysign(65536.0 + 64.0 * (bits & 0x3FF).to(torch.float32), v)
        v = torch.where(exp == 31, big, v)
        return torch.where(exp == 0, v * 0.0, v)
    return x.to(torch.float32)


def store_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Kernel store: float32 values as a plane of ``dtype``."""
    if dtype == torch.float16:
        c = x.clamp(-_F16_MAX, _F16_MAX)
        c = torch.where(c.abs() < _F16_MIN_NORMAL, c * 0.0, c)
        return c.to(torch.float16)
    return x.to(dtype)


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``f32_of(store_as(x, dtype))``: the values a store then a load give."""
    if dtype == torch.float32:
        return x
    return f32_of(store_as(x, dtype))


def split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A real f32 tensor as its bf16 hi part and bf16 lo remainder (both
    float32 tensors holding bf16 values)."""
    hi = a.to(torch.bfloat16).to(torch.float32)
    return hi, (a - hi).to(torch.bfloat16).to(torch.float32)


def csplit(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A complex64 tensor as ``(hi, lo)`` complex tensors, real and
    imaginary parts split apart."""
    rh, rl = split(z.real.contiguous())
    ih, il = split(z.imag.contiguous())
    return torch.complex(rh, ih), torch.complex(rl, il)


_CHUNK = 1 << 24  # complex entries of one operand chunk of the bf16x3 products


def _cmatmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = csplit(a)
    bh, bl = csplit(b)
    return torch.matmul(ah, bh + bl) + torch.matmul(al, bh)


def cmatmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` of complex64 tensors in dot mode ``mode``: an operator
    (2-D) times a batch of planes or a batch times an operator. bf16x3
    runs a chunk of the planes at a time (their hi and lo parts are four
    plane-sized copies at once otherwise). On the meta device (shapes only:
    the dry runs of the dispatch) it is one product."""
    if mode == "f32" or b.device.type == "meta":
        return torch.matmul(a, b)
    if a.dim() == 2:  # the operator on the left: columns are independent
        out = torch.empty((*b.shape[:-2], a.shape[0], b.shape[-1]),
                          dtype=b.dtype, device=b.device)
        step = max(1, _CHUNK // max(1, b[..., :1].numel()))
        for lo in range(0, b.shape[-1], step):
            out[..., lo:lo + step] = _cmatmul3(a, b[..., lo:lo + step])
        return out
    rows = a.reshape(-1, a.shape[-1])  # the operator on the right: rows are
    out = torch.empty((rows.shape[0], b.shape[-1]), dtype=a.dtype,
                      device=a.device)
    step = max(1, _CHUNK // rows.shape[-1])
    for lo in range(0, rows.shape[0], step):
        out[lo:lo + step] = _cmatmul3(rows[lo:lo + step], b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def pair_sum(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``gram.pair_sum`` in dot mode ``mode``; bf16x3 a chunk of the
    leading axis at a time, the chunks' sums added in order."""
    from dqc_tpu_torch.ops.kernels.gram import pair_sum as exact

    if mode == "f32" or a.device.type == "meta":
        return exact(a, b)
    step = max(1, _CHUNK // max(1, a[0].numel()))
    out = None
    for lo in range(0, a.shape[0], step):
        ah, al = csplit(a[lo:lo + step])
        bh, bl = csplit(b[lo:lo + step])
        t = exact(ah, bh + bl) + exact(al, bh)
        out = t if out is None else out + t
    return out


def load_b(br, bi) -> torch.Tensor:
    """Planes of any storage (the cotangent's, or the forward planes'
    float32 / bfloat16) as a complex64 tensor (the kernels' decode)."""
    return torch.complex(f32_of(br), f32_of(bi))


def round_b(B: torch.Tensor, dtype) -> torch.Tensor:
    """A complex state (cotangent or forward) rounded to the planes'
    storage, as a store and a reload give it."""
    if dtype == torch.float32:
        return B
    return torch.complex(quantize(B.real.contiguous(), dtype),
                         quantize(B.imag.contiguous(), dtype))


def store_b(B: torch.Tensor, dtype):
    """A complex state (cotangent or forward) as planes of ``dtype`` (the
    kernels' encode)."""
    return (store_as(B.real.contiguous(), dtype),
            store_as(B.imag.contiguous(), dtype))


def check_fwd(what: str, fr, fi, dot_mode: str = "f32", f16: bool = False) -> None:
    """F stored as float32 or bfloat16 (both planes of one dtype), the
    forward dot mode known. ``f16``: float16 input planes too (a cotangent
    stored as "f16" handed to a forward apply, as the per-term fallback of
    a dense cross-group gate does); a kernel that does not take them
    (``gram``, ``merged_fact_apply``, ``diag_sweep``) raises
    ``NotImplementedError``."""
    dtypes = STORAGE_DTYPES if f16 else FWD_DTYPES
    if fr.dtype not in dtypes or fi.dtype != fr.dtype:
        if fr.dtype == torch.float16 or fi.dtype == torch.float16:
            raise NotImplementedError(
                f"{what}: float16 input planes (a cotangent stored as \"f16\" "
                f"handed to a forward kernel) are not ported; {NOT_PORTED_F16}")
        raise TypeError(f"{what}: forward planes of {fr.dtype} and {fi.dtype}, "
                        f"want one of {dtypes}")
    check_dot_mode(what, dot_mode)


def check_f(what: str, fr, fi, dot_mode: str = "f32") -> None:
    """An adjoint's forward planes F: float32 or bfloat16, both of one dtype
    (no storage makes them float16), the forward dot mode known."""
    if fr.dtype not in FWD_DTYPES or fi.dtype != fr.dtype:
        raise TypeError(f"{what}: forward planes of {fr.dtype} and {fi.dtype}, "
                        f"want one of {FWD_DTYPES}")
    check_dot_mode(what, dot_mode)


def count_fwd(wrapper, fdtype, dot_mode: str) -> None:
    """Count a launch on bf16 forward planes ("fwd_bf16") and in the forward
    bf16x3 ("fwd_bf16x3") in ``wrapper.mode_launches``."""
    if fdtype == torch.bfloat16:
        wrapper.mode_launches["fwd_bf16"] += 1
    if dot_mode == "bf16x3":
        wrapper.mode_launches["fwd_bf16x3"] += 1


def check_modes(what: str, fr, br, bi, bwd_mode: str, gram_mode: str,
                dot_mode: str = "f32") -> None:
    """F of the forward storages, B of the storage dtypes (both of one),
    the dot modes known."""
    check_f(what, fr, fr, dot_mode)
    storage_kind(br.dtype)
    if bi.dtype != br.dtype:
        raise TypeError(f"{what}: cotangent planes of two dtypes")
    check_dot_mode(what, bwd_mode)
    check_dot_mode(what, gram_mode)


def count_storage(wrapper, dtype) -> None:
    """Count a launch whose cotangent planes are stored reduced under the
    storage's name in ``wrapper.mode_launches``."""
    if dtype != torch.float32:
        wrapper.mode_launches[storage_name(dtype)] += 1


def count_modes(wrapper, bdtype, bwd_mode: str, gram_mode: str) -> None:
    """Count a launch's storage and dot-mode variants in ``mode_launches``."""
    count_storage(wrapper, bdtype)
    if bwd_mode == "bf16x3":
        wrapper.mode_launches["bf16x3"] += 1
    if gram_mode == "bf16x3":
        wrapper.mode_launches["gram_bf16x3"] += 1


def check_apply_storage(what: str, xdtype, ydtype) -> None:
    """The storages an apply reads and writes in one pass: f32 into any
    storage (a seed from the forward planes), or one storage in and out (in
    place on the cotangent planes)."""
    storage_kind(xdtype)
    storage_kind(ydtype)
    if xdtype not in (torch.float32, ydtype):
        raise TypeError(f"{what}: planes stored as {xdtype} into {ydtype}: an "
                        "apply reads f32 into any storage, or one storage in "
                        "and out")


def seed_out(yr, yi, conj: bool, acc, out_dtype=None):
    """The apply kernels' seed modes on an f32 result: ``[acc +] conj?(y)``
    stored as the accumulator's dtype, or ``out_dtype`` (f32 when None),
    the accumulator decoded and the sum encoded as the kernels do."""
    if conj:
        yi = -yi
    if acc is not None:
        out_dtype = acc[0].dtype
        yr, yi = f32_of(acc[0]) + yr, f32_of(acc[1]) + yi
    dt = torch.float32 if out_dtype is None else out_dtype
    return store_as(yr, dt).contiguous(), store_as(yi, dt).contiguous()


_MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}


def ulps_apart(got, want, dtype, chunk: int = 1 << 24) -> float:
    """The largest error over the amplitudes of two plane pairs ``(re,
    im)`` (stored as any storage, decoded here), in units of the storage
    ``dtype``'s ulp at the larger of the amplitude's modulus and the
    planes' rms: the storage rounds each part to its own ulp, a complex
    product (a diagonal run's phase) mixes the parts, and an amplitude far
    below the planes' scale (or in f16's flushed band) is held at the
    scale's precision, since a product over a stored plane sums the
    rounding of amplitudes at that scale. The yardstick of the kernels
    against their plain versions under reduced storage; computed ``chunk``
    amplitudes at a time (a 30-qubit plane pair in float64 would not fit
    beside the planes)."""
    flat = [t.reshape(-1) for t in (*got, *want)]
    n = flat[0].numel()

    def parts(lo):
        return [f32_of(t[lo:lo + chunk]).to(torch.float64) for t in flat]

    total = 0.0
    for lo in range(0, n, chunk):
        _, _, wr, wi = parts(lo)
        total += float((wr * wr + wi * wi).sum())
    floor = (total / max(n, 1)) ** 0.5
    worst = 0.0
    for lo in range(0, n, chunk):
        gr, gi, wr, wi = parts(lo)
        mag = torch.sqrt(wr * wr + wi * wi).clamp_min(max(floor, 1e-300))
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - _MANTISSA_BITS[dtype])
        err = torch.maximum((gr - wr).abs(), (gi - wi).abs())
        worst = max(worst, float((err / ulp).max()))
    return worst


def gram_tolerance(dtype) -> float:
    """The relative tolerance of a pair gram or a Q reduction (of its
    largest entry) next to B stored as ``dtype``: 1e-5 for float32, and
    2^-(p + 1) (half an ulp, p mantissa bits) for a reduced storage: B is
    defined to half an ulp, and the grams and Q of a step that reads B after
    one or two stores sum entries that two orders of f32 sums rounded the
    other way."""
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -(_MANTISSA_BITS[dtype] + 1)
