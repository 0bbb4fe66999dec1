"""Port of tpu_mpc/protocols/cclst19 (host-only, as in the reference)."""
