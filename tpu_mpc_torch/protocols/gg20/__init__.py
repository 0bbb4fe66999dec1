"""Port of tpu_mpc/protocols/gg20 (PyTorch)."""
