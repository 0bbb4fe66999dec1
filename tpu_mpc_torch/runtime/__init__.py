"""The runtime (port of tpu_mpc/runtime): per-party GG20 state machines over
the HTTP relay and its CLI, and the GG18 clients over the KV relay.

The JAX package's apply_platform_env (its platform switch for CLI
processes) has no counterpart here: every main() takes `--device`
(default "cuda"), and a process without a card fails unless it passes
`--device cpu`.
"""

from . import wire, state_machine  # noqa: F401
