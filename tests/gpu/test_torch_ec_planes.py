"""K4's comb table as u8 tensor-core planes (tpu_mpc_torch/ec/pallas_ec.py:
comb_planes), on the CPU: the planes hold exactly the comb table's bytes, and
a numpy emulation of the kernel's one-hot product (mma.sync.m16n8k32 u8,
fragments as the PTX ISA lays them out, indices as csrc/ec_kernels.cu:
k4_kernel computes them) selects tab[w, d] for every digit d."""

import numpy as np
import pytest

from tpu_mpc_torch.ec import pallas_ec as tpe
from tpu_mpc_torch.host import ec as hec

BASES = {"G": hec.G, "BASE_POINT2": hec.BASE_POINT2}


def _entry_bytes(tab):
    """[32, 256, 2, 16] 16-bit limbs -> [32, 256, 64] bytes (x then y, LE)."""
    t = tab.astype(np.int64)
    return np.stack([t & 0xFF, t >> 8], -1).reshape(tab.shape[0], tab.shape[1], 64)


@pytest.mark.parametrize("base", sorted(BASES))
def test_comb_planes_recombine_to_the_table(base):
    tab = tpe._comb8_host(BASES[base])
    planes = tpe._comb8_for(BASES[base], "cpu")[1].numpy()
    assert planes.dtype == np.uint8 and planes.shape == (32, 256 * 64)
    # byte i of register r of thread l = 4 g + t in chunk (kk, j) is byte
    # 8 j + g of entry 32 kk + 16 r + 4 t + i
    kk, j, l, r, i = np.meshgrid(np.arange(8), np.arange(8), np.arange(32), np.arange(2),
                                 np.arange(4), indexing="ij")
    ent = 32 * kk + 16 * r + 4 * (l % 4) + i
    byte = 8 * j + l // 4
    got = np.zeros((32, 256, 64), np.int64)
    got[:, ent.reshape(-1), byte.reshape(-1)] = planes.reshape(32, -1)
    assert np.array_equal(got, _entry_bytes(tab))
    # every (entry, byte) cell is written once
    assert len(set(zip(ent.reshape(-1).tolist(), byte.reshape(-1).tolist()))) == 256 * 64


def _a_frag_matrix(frag):
    """[..., 32 threads, 4 regs] u32 A fragments -> [..., 16, 32] u8 matrix:
    byte b of reg q of thread (g, t) is row g + 8 (q & 1), col 4 t + b + 16 (q >> 1)."""
    r, k = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    th, q = 4 * (r % 8) + (k % 16) // 4, r // 8 + 2 * (k // 16)
    return (frag[..., th, q] >> (8 * (k % 4))) & 0xFF


def _b_frag_matrix(frag):
    """[..., 32 threads, 2 regs] u32 B fragments -> [..., 32, 8] u8 matrix:
    byte i of reg r of thread (g, t) is row 4 t + i + 16 r, col g."""
    k, n = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
    th = 4 * n + (k % 16) // 4
    return (frag[..., th, k // 16] >> (8 * (k % 4))) & 0xFF


def _onehot4(d, e0):
    rel = (d - e0) & 0xFFFFFFFF
    return np.where(rel < 4, np.left_shift(1, 8 * np.minimum(rel, 3)), 0).astype(np.int64)


@pytest.mark.parametrize("base", sorted(BASES))
def test_one_hot_product_selects_every_entry(base):
    tab = tpe._comb8_host(BASES[base])
    planes = tpe._comb8_for(BASES[base], "cpu")[1].numpy().astype(np.int64)
    digits = np.arange(256).reshape(16, 16)            # 16 blocks of 16 lanes: every d
    ln = np.arange(32)
    fg, ft = ln // 4, ln % 4
    for w in (0, 13, 31):
        # B fragments: thread ln reads 8 bytes at ((kk * 8 + j) * 32 + ln) * 8
        chunks = planes[w].reshape(8, 8, 32, 2, 4)
        bfrag = (chunks << (8 * np.arange(4))).sum(-1)          # [kk, j, 32, 2]
        Bm = _b_frag_matrix(bfrag)                               # [kk, j, 32, 8]
        for blk in digits:
            d0, d1 = blk[fg], blk[fg + 8]                        # rows fg, fg + 8
            D = np.zeros((8, 16, 8), np.int64)                   # [j, row, col]
            for kk in range(8):
                e0 = 32 * kk + 4 * ft
                afrag = np.stack([_onehot4(d0, e0), _onehot4(d1, e0),
                                  _onehot4(d0, e0 + 16), _onehot4(d1, e0 + 16)], -1)
                A = _a_frag_matrix(afrag)                        # [16, 32]
                D += np.einsum("rk,jkn->jrn", A, Bm[kk])
            # thread (g, t) holds cols 2t, 2t+1 of rows g, g + 8 of each n-tile j
            # and stores them as bytes 8 j + 2 t, 8 j + 2 t + 1 of the row's lane
            sel = np.zeros((16, 64), np.int64)
            for j in range(8):
                for i in range(4):
                    row, col = fg + 8 * (i >> 1), 2 * ft + (i & 1)
                    sel[row, 8 * j + col] = D[j, row, col]
            assert sel.max() <= 255                              # one nonzero term
            limbs = (sel[:, 0::2] | (sel[:, 1::2] << 8)).reshape(16, 2, 16)
            assert np.array_equal(limbs, tab[w, blk].astype(np.int64))
