"""tpu_mpc_torch — the PyTorch/CUDA port of tpu_mpc for NVIDIA Hopper.

The package mirrors tpu_mpc's file layout and public names; each module's
reference is the file of the same path under tpu_mpc/.  It imports torch,
numpy and the standard library only — never jax, never tpu_mpc.

Layers on the ported main path (GG20 offline_stage + sign_online):
  core/      limbs, RNS Montgomery modexp (K1), ModCtx, 256-bit scalar field
  ec/        secp256k1 points; GLV ladder (K3), comb (K4), affine (K5)
  csrc/      the hand-written CUDA kernels for sm_90a, loaded with ctypes
  hashes/    Fiat-Shamir SHA-256 (byte-identical to the reference)
  paillier/, zk/, mta/, vss/, protocols/gg20/

Device rule: entry points take `device`, default "cuda".  The CPU runs only
when the caller passes device="cpu" (the tests do); every kernel wrapper
then takes its plain PyTorch version.  On a CUDA tensor a wrapper launches
its kernel or raises.
"""

__version__ = "0.1.0"
