"""Port of tpu_mpc/protocols (PyTorch)."""
