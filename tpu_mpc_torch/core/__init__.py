"""Port of tpu_mpc/core (PyTorch)."""
