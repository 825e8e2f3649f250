"""models of dqc_tpu_torch (see the package docstring)."""
