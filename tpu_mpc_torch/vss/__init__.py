"""Port of tpu_mpc/vss (PyTorch)."""
