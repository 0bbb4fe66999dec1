"""The work counts of K1 and K2 against counts worked by hand at two shapes
each; a count depends only on the numbers of the input shapes; the module
imports nothing of the program."""

import inspect

import pytest
import torch

from portbench import instrument, roofline
from portbench.roofline import peaks


def test_k1_by_hand():
    # 512 lanes, 2048-bit moduli one a lane, 2048-bit exponents:
    # products 2048 squarings + 512 windows + 14 table = 2574, each
    # 2 * 256 * 256 = 131072 u8 multiply-adds;
    # bytes 512 * (256 in + 256 out + 256 exponent) + 512 * 256 moduli
    assert roofline.k1_work(512, 2048, 2048, 512) == (512 * 2574 * 131072, 524288)
    assert roofline.k1_work(512, 2048, 2048, 512) == (172_738_215_936, 524_288)
    # 16384 lanes, 4096 bits, 256-bit exponents, one shared modulus:
    # 256 + 64 + 14 = 334 products of 2 * 512 * 512 = 524288;
    # bytes 16384 * (512 + 512 + 32) + 512
    assert roofline.k1_work(16384, 4096, 256, 1) == (2_869_038_153_728, 17_302_016)


def test_k2_by_hand():
    # 8192 lanes, 4096 bits, 580 windows, one modulus, 2 key groups:
    # 8192 * 580 products of 524288; tables 580 * min(8192, 32) entries of
    # 512 B; bytes 8192 * (512 out + 290 exponent + 4 group) + 512
    assert roofline.k2_work(8192, 4096, 580, 1, 2) == (
        2_491_081_031_680, 8192 * 806 + 512 + 580 * 32 * 512)
    # 12 lanes, 2048 bits, 256 + 776 windows, 12 moduli, 12 groups:
    # 12 * 1032 products of 131072; min(12, 192) = 12 entries a window
    assert roofline.k2_work(12, 2048, 1032, 12, 12) == (
        1_623_195_648, 12 * (256 + 516 + 4) + 12 * 256 + 1032 * 12 * 256)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert roofline.bound_ms(peaks.U8_MACS_PER_S, 0) == pytest.approx(1e3)
    assert roofline.bound_ms(0, peaks.HBM_BYTES_PER_S) == pytest.approx(1e3)
    macs, nbytes = roofline.k2_work(8192, 2048, 644, 1, 2)
    assert roofline.bound_ms(macs, nbytes) == pytest.approx(macs / peaks.U8_MACS_PER_S * 1e3)


@pytest.mark.parametrize("bits", [2048, 4096])
def test_k2_is_operation_bound_for_any_digits(bits):
    """At the main path's shapes, even with every lane reading an entry of
    its own in every window."""
    for lanes, windows in ((512, 64), (6144, 580), (16384, 1032)):
        # as many key groups as lanes: lanes * windows entries counted
        macs, nbytes = roofline.k2_work(lanes, bits, windows, lanes, lanes)
        assert nbytes > lanes * windows * roofline.limbs8(bits)
        assert nbytes / peaks.HBM_BYTES_PER_S < macs / peaks.U8_MACS_PER_S


def test_counts_depend_only_on_shapes():
    for fn in (roofline.k1_work, roofline.k2_work):
        assert all(p.annotation in ("int", int) for p in inspect.signature(fn).parameters.values())
    g = torch.Generator().manual_seed(0)
    rows = lambda C, W: torch.randint(0, 1 << 16, (C, W), generator=g)
    shapes = []
    for _ in range(2):
        x, e = rows(24, 130), torch.randint(0, 1 << 31, (24, 8), generator=g)
        shapes.append(instrument.launch_shape("K1", (x, e, rows(1, 390), 2048)))
    assert shapes[0] == shapes[1] == {"lanes": 24, "mod_bits": 2048, "exp_bits": 256,
                                      "moduli": 1}
    tab = torch.zeros((4, 16, 3, 130), dtype=torch.int32)
    k2 = [instrument.launch_shape("K2", (torch.randint(0, 9, (24, 8), generator=g),
                                         torch.randint(0, 3, (24,), generator=g),
                                         rows(24, 390), [tab, tab], [4, 3], [0, 1], 2048))
          for _ in range(2)]
    assert k2[0] == k2[1] == {"lanes": 24, "mod_bits": 2048, "windows": 7, "moduli": 24,
                              "groups": 3}
    assert roofline.k1_work(**shapes[0]) == roofline.k1_work(**shapes[1])
