"""Port of tpu_mpc/hashes (PyTorch)."""
