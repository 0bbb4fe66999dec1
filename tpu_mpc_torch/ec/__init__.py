"""Port of tpu_mpc/ec (PyTorch)."""
