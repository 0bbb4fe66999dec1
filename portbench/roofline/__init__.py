"""Work counts of the RNS kernels K1 and K2, and the least time they allow.

A count is of the function a kernel computes, from the numbers of its
inputs' shapes, and not of the steps of the present design: a redesigned
kernel leaves it as it is.  Every b-bit modular product counts as two
schoolbook products of b/8 u8 limbs (the product and its reduction), as
u8 multiply-adds; bytes count each input read once and each output
written once, at the width the function needs.  The least time is the
larger of the multiply-adds over the u8 tensor-core peak and the bytes over
the memory peak (peaks.py).

K1, x^e mod m on each lane: e's bits in squarings, one product per window
of WINDOW bits, and the 2^WINDOW - 2 products of the window table.

K2, the product of table entries T[j][digit_j(e)][group] over j: one
product per window and lane.  Its tables are read at most min(lanes,
16 G) entries a window (16 digits a group, and no lane reads two), counted
whole, so that the count need not read the digits.  That can only raise
the byte bound; from 2048 bits on, an entry takes less time at the memory
peak than its product's multiply-adds take at the tensor-core peak, so at
the main path's shapes (hundreds of lanes and windows and more) the bound
is the operation bound whatever the digits.

Imports nothing of the program.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, U8_MACS_PER_S

WINDOW = 4


def limbs8(bits: int) -> int:
    return -(-bits // 8)


def modmul_macs(bits: int) -> int:
    """u8 multiply-adds of one b-bit modular product: product + reduction."""
    n = limbs8(bits)
    return 2 * n * n


def k1_work(lanes: int, mod_bits: int, exp_bits: int, moduli: int) -> tuple:
    """(u8 multiply-adds, bytes) of x^e mod m over `lanes` lanes, e of
    exp_bits bits, m of mod_bits bits, `moduli` distinct moduli."""
    products = exp_bits + -(-exp_bits // WINDOW) + (1 << WINDOW) - 2
    b = limbs8(mod_bits)
    nbytes = lanes * (2 * b + limbs8(exp_bits)) + moduli * b
    return lanes * products * modmul_macs(mod_bits), nbytes


def k2_work(lanes: int, mod_bits: int, windows: int, moduli: int, groups: int) -> tuple:
    """(u8 multiply-adds, bytes) of a product of `windows` table entries on
    each of `lanes` lanes, WINDOW-bit digits, `groups` key groups' tables."""
    b = limbs8(mod_bits)
    entries = windows * min(lanes, 16 * groups)
    nbytes = (lanes * (b + limbs8(windows * WINDOW) + 4) + moduli * b + entries * b)
    return lanes * windows * modmul_macs(mod_bits), nbytes


def bound_ms(macs: float, nbytes: float) -> float:
    """The least time, ms, for `macs` u8 multiply-adds and `nbytes` bytes."""
    return max(macs / U8_MACS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
