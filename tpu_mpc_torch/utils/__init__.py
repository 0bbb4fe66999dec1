"""Port of tpu_mpc/utils (PyTorch)."""
