"""VQE-Ising and QAOA MaxCut under reduced cotangent storage against the
JAX package on the CPU: the cases and bars of
tests/test_torch_storage_models.py (its docstring), split off to keep each
file short."""

import pytest
import torch

from test_torch_storage_models import CASES, _restore, check_model  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("storage", ["mixed", "f16"])
@pytest.mark.parametrize("kind, n, L", [k for k in CASES if k[0] != "cnot"],
                         ids=lambda x: str(x))
def test_model_reduced_storage_matches_jax(kind, n, L, storage):
    check_model(kind, n, L, storage)
