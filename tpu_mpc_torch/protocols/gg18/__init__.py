"""Port of tpu_mpc/protocols/gg18 (PyTorch)."""
