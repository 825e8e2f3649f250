#!/usr/bin/env python3
"""How far the port's dual adjoint on bf16 planes lands from its plain
version and from an exact reference, over seeds, on one CUDA card.

    python3 tools/torch_dual_bf16_ulps.py [seed ...]   # from the repo root

The case is chip_smoke.py phase 3i's ``29q_g0_first_diag_first_bf16`` row
at 29 qubits: F and B stored bf16, the uncomputes in the "f32" dot mode,
the transports and pair grams bf16x3, a diagonal run met after the pair
(so F is rounded to bf16 three times: between the steps, before the run
and at the store). For each seed it prints, for the F planes in bf16 ulps
at max(|amplitude|, rms) (``_storage.ulps_apart``, the phase's yardstick):
the kernel against the plain version (the phase's bar is 2), the kernel
against the same chain in complex128 (each product exact, rounded to bf16
where the kernel rounds) and the plain version against it.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dqc_tpu_torch.ops.kernels import _storage as st  # noqa: E402
from dqc_tpu_torch.ops.kernels.block_backward_dual import (  # noqa: E402
    block_backward_dual, block_backward_dual_plain)
from dqc_tpu_torch.ops.kernels.dual_apply import diag_run  # noqa: E402

BF16 = torch.bfloat16
A29 = 1 << 15


def case(seed: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def unitary(X):
        q, _ = torch.linalg.qr(torch.complex(randn(X, X), randn(X, X)))
        return q.real.contiguous(), q.imag.contiguous()

    def phases(*shape):
        z = torch.polar(torch.ones(shape, device=dev),
                        6.2832 * torch.rand(shape, generator=gen, device=dev))
        return z.real.contiguous(), z.imag.contiguous()

    def tables(a):
        return (*phases(128, 128), *phases(a, 128), *phases(a, 128))

    ops = [t for _ in range(4) for t in unitary(128)]
    planes = ([st.store_as(randn(A29, 128, 128), BF16) for _ in range(2)]
              + [st.store_as(0.5 * randn(A29, 128, 128), BF16) for _ in range(2)])
    ti, tf = tables(A29), tables(A29)
    kw = dict(g0_first=True, diag_first_fwd=True, diag_inv_tables=ti,
              diag_tables=tf, bwd_mode="bf16x3", gram_mode="bf16x3",
              dot_mode="f32")
    plain = block_backward_dual_plain(*planes, *ops, **kw)[:2]
    kernel = block_backward_dual(*[p.clone() for p in planes], *ops, **kw)[:2]
    torch.cuda.synchronize()
    # the F chain in complex128: the sublane uncompute, bf16, the lane
    # uncompute, bf16 (the staging before the run), times Dinv, bf16
    c128 = torch.complex128

    def to_bf16(z):
        return torch.complex(z.real.to(BF16).double(), z.imag.to(BF16).double())

    e0inv = torch.complex(ops[0], ops[1]).to(c128)
    e1inv = torch.complex(ops[4], ops[5]).to(c128)
    F = torch.complex(planes[0].double(), planes[1].double())
    F = to_bf16(torch.matmul(e1inv, F))
    F = to_bf16(torch.matmul(F, e0inv.transpose(0, 1)))
    F = to_bf16(F * diag_run(ti).to(c128))
    exact = (F.real.to(BF16), F.imag.to(BF16))
    return {"kernel_vs_plain": st.ulps_apart(kernel, plain, BF16),
            "kernel_vs_exact": st.ulps_apart(kernel, exact, BF16),
            "plain_vs_exact": st.ulps_apart(plain, exact, BF16)}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    seeds = [int(s) for s in sys.argv[1:]] or [99, 1234, 7, 5, 11, 12]
    dev = torch.device("cuda")
    for seed in seeds:
        print(json.dumps({"seed": seed, **case(seed, dev)}), flush=True)
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
