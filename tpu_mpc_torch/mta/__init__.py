"""Port of tpu_mpc/mta (PyTorch)."""
