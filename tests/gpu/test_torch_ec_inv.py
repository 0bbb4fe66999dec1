"""K5's field inversion (tpu_mpc_torch/csrc/ec_kernels.cu: fe_inv), on the
CPU: a numpy emulation of exactly the kernel's limb steps (fe_to_s30,
divsteps_30 with its masks, update_de_30 / update_fg_30 on 9 signed 30-bit
limbs, normalize_30, s30_to_fe; the C types' widths and wraps as numpy
dtypes, one array element per lane) against python's pow(z, -1, p), on edge
values and seeded random ones.  The constants are read from the kernel's
source.  Also the plain version K5 is held against on the card
(affine_plain) at the same Z values."""

import os
import re

import numpy as np
import torch

from tpu_mpc_torch.ec import pallas_ec as tpe

P = 2**256 - 2**32 - 977
SRC = os.path.join(os.path.dirname(tpe.__file__), os.pardir, "csrc", "ec_kernels.cu")

EDGE = list(tpe.Z_EDGE)


def _src_consts():
    src = open(SRC).read()

    def num(name):
        m = re.search(rf"\b{name} = (-?0x[0-9A-Fa-f]+|-?[0-9]+)u?\b", src)
        assert m, name
        return int(m.group(1), 0)

    return {k: num(k) for k in ("kM30", "kP30_0", "kP30_1", "kP30_8", "kPinv30")}


C = _src_consts()
M30 = np.uint32(C["kM30"])
P30 = [C["kP30_0"], C["kP30_1"], 0, 0, 0, 0, 0, 0, C["kP30_8"]]
PINV = np.uint32(C["kPinv30"])


def test_constants():
    assert C["kM30"] == 2**30 - 1
    assert sum(v << (30 * i) for i, v in enumerate(P30)) == P
    assert P * C["kPinv30"] % 2**30 == 1
    assert all(-(2**30) < v < 2**30 for v in P30)


def _words(zs):
    """python ints -> [8, n] uint32 limbs (little-endian), one column a lane"""
    return np.asarray([[(z >> (32 * k)) & 0xFFFFFFFF for z in zs] for k in range(8)],
                      dtype=np.uint32)


def _int(words):
    return [sum(int(words[k, j]) << (32 * k) for k in range(8)) for j in range(words.shape[1])]


def _fe_to_s30(a):
    r = [(a[0] & M30).astype(np.int32)]
    for i in range(1, 8):
        s = 32 - 2 * i                     # __funnelshift_r(a[i-1], a[i], s)
        r.append((((a[i - 1] >> np.uint32(s)) | (a[i] << np.uint32(32 - s))) & M30)
                 .astype(np.int32))
    r.append((a[7] >> np.uint32(16)).astype(np.int32))
    return r


def _s30_to_fe(s):
    return np.stack([(s[k].astype(np.uint32) >> np.uint32(2 * k))
                     | (s[k + 1].astype(np.uint32) << np.uint32(30 - 2 * k))
                     for k in range(8)])


def _divsteps_30(zeta, f, g):
    n = f.shape
    u, v = np.ones(n, np.uint32), np.zeros(n, np.uint32)
    q, r = np.zeros(n, np.uint32), np.ones(n, np.uint32)
    for _ in range(30):
        c1 = (zeta >> 31).astype(np.uint32)
        c2 = np.uint32(0) - (g & np.uint32(1))
        x, y, z = (f ^ c1) - c1, (u ^ c1) - c1, (v ^ c1) - c1
        g = g + (x & c2)
        q = q + (y & c2)
        r = r + (z & c2)
        c3 = c1 & c2
        zeta = (zeta ^ c3.astype(np.int32)) - np.int32(1)
        f = f + (g & c3)
        u = u + (q & c3)
        v = v + (r & c3)
        g = g >> np.uint32(1)
        u = u << np.uint32(1)
        v = v << np.uint32(1)
    return zeta, tuple(w.astype(np.int32) for w in (u, v, q, r))


def _w(a):
    return a.astype(np.int64)


def _low30(c):
    return (c.astype(np.uint32) & M30).astype(np.int32)


def _update_de_30(d, e, t):
    u, v, q, r = t
    sd, se = d[8] >> 31, e[8] >> 31
    md = (u & sd) + (v & se)
    me = (q & sd) + (r & se)
    cd = _w(u) * _w(d[0]) + _w(v) * _w(e[0])
    ce = _w(q) * _w(d[0]) + _w(r) * _w(e[0])
    md = md - ((PINV * cd.astype(np.uint32) + md.astype(np.uint32)) & M30).astype(np.int32)
    me = me - ((PINV * ce.astype(np.uint32) + me.astype(np.uint32)) & M30).astype(np.int32)
    cd = cd + np.int64(P30[0]) * _w(md)
    ce = ce + np.int64(P30[0]) * _w(me)
    assert not (cd & 0x3FFFFFFF).any() and not (ce & 0x3FFFFFFF).any()
    cd, ce = cd >> 30, ce >> 30
    d, e = list(d), list(e)
    for i in range(1, 9):
        cd = cd + _w(u) * _w(d[i]) + _w(v) * _w(e[i])
        ce = ce + _w(q) * _w(d[i]) + _w(r) * _w(e[i])
        if P30[i]:
            cd = cd + np.int64(P30[i]) * _w(md)
            ce = ce + np.int64(P30[i]) * _w(me)
        d[i - 1], e[i - 1] = _low30(cd), _low30(ce)
        cd, ce = cd >> 30, ce >> 30
    d[8], e[8] = cd.astype(np.int32), ce.astype(np.int32)
    return d, e


def _update_fg_30(f, g, t):
    u, v, q, r = t
    cf = _w(u) * _w(f[0]) + _w(v) * _w(g[0])
    cg = _w(q) * _w(f[0]) + _w(r) * _w(g[0])
    assert not (cf & 0x3FFFFFFF).any() and not (cg & 0x3FFFFFFF).any()
    cf, cg = cf >> 30, cg >> 30
    f, g = list(f), list(g)
    for i in range(1, 9):
        cf = cf + _w(u) * _w(f[i]) + _w(v) * _w(g[i])
        cg = cg + _w(q) * _w(f[i]) + _w(r) * _w(g[i])
        f[i - 1], g[i - 1] = _low30(cf), _low30(cg)
        cf, cg = cf >> 30, cg >> 30
    f[8], g[8] = cf.astype(np.int32), cg.astype(np.int32)
    return f, g


def _carry_30(d):
    d = list(d)
    for i in range(8):
        d[i + 1] = d[i + 1] + (d[i] >> 30)
        d[i] = d[i] & np.int32(C["kM30"])
    return d


def _normalize_30(d, sign):
    add1 = d[8] >> 31
    d = [x + (np.int32(P30[i]) & add1) for i, x in enumerate(d)]
    neg = sign >> 31
    d = _carry_30([(x ^ neg) - neg for x in d])
    add2 = d[8] >> 31
    return _carry_30([x + (np.int32(P30[i]) & add2) for i, x in enumerate(d)])


def _s30_val(s):
    return [sum(int(s[i][j]) << (30 * i) for i in range(9)) for j in range(s[0].shape[0])]


def fe_inv_emulated(zs):
    """The kernel's fe_inv on a batch of canonical nonzero z: the inverses
    and the final (f, g) values."""
    n = len(zs)
    g = _fe_to_s30(_words(zs))
    f = [np.full(n, v, np.int32) for v in P30]
    d = [np.zeros(n, np.int32) for _ in range(9)]
    e = [np.zeros(n, np.int32) for _ in range(9)]
    e[0] = np.ones(n, np.int32)
    zeta = np.full(n, -1, np.int32)
    for _ in range(20):
        zeta, t = _divsteps_30(zeta, f[0].astype(np.uint32), g[0].astype(np.uint32))
        assert (np.abs(zeta) <= 601).all()
        d, e = _update_de_30(d, e, t)
        f, g = _update_fg_30(f, g, t)
    d = _normalize_30(d, f[8])
    assert all(((x >= 0) & (x <= C["kM30"])).all() for x in d)
    return _int(_s30_to_fe(d)), _s30_val(f), _s30_val(g)


def _inputs():
    rng = np.random.default_rng(20261017)
    rand = [int.from_bytes(rng.bytes(32), "little") % P or 1 for _ in range(64)]
    return EDGE + rand


def test_limb_conversions_round_trip():
    zs = _inputs() + [0]
    s = _fe_to_s30(_words(zs))
    assert _s30_val(s) == zs
    assert _int(_s30_to_fe(s)) == zs


def test_divstep_inverse_equals_pow():
    zs = _inputs()
    assert all(0 < z < P for z in zs)
    inv, f, g = fe_inv_emulated(zs)
    # 600 divsteps end every input at g = 0, f = +-1 (590 suffice for 256 bits)
    assert all(v == 0 for v in g) and all(v in (1, -1) for v in f)
    assert {v for v in f} == {1, -1}          # both signs occur: normalize's negation runs
    assert inv == [pow(z, -1, P) for z in zs]


def test_affine_plain_at_edge_z():
    """affine_plain (K5's oracle on the card) at the same Z values and at
    Z = 0 (a dummy 1 is inverted: x = X, y = Y): x = X / Z^2, y = Y / Z^3."""
    rng = np.random.default_rng(5)
    zs = EDGE + [0]
    xs = [int.from_bytes(rng.bytes(32), "little") % P for _ in zs]
    ys = [int.from_bytes(rng.bytes(32), "little") % P for _ in zs]

    def limbs16(vals):
        return torch.as_tensor([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals],
                               dtype=torch.int64)

    pts = torch.stack([limbs16(xs), limbs16(ys), limbs16(zs)], 1)
    out = tpe.affine_plain(pts)
    val = lambda row: sum(int(v) << (16 * i) for i, v in enumerate(row.tolist()))
    got = [(val(out[j, 0]), val(out[j, 1])) for j in range(len(zs))]
    want = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(z or 1, -1, P)
        want.append((x * zi * zi % P, y * zi * zi * zi % P))
    assert got == want
