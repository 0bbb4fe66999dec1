"""Port of tpu_mpc/protocols/lindell17 (PyTorch)."""
