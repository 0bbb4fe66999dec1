"""Port of tpu_mpc/zk (PyTorch)."""
