"""Port of tpu_mpc/host (PyTorch)."""
