"""Port of tpu_mpc/paillier (PyTorch)."""
