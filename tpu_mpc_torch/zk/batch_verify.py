"""Cross-session small-exponent batch verification of the N^2-modexp proof
checks (port of tpu_mpc/zk/batch_verify.py).

When the sessions axis shares one key set, the S per-session verifier
equations collapse to one batched check [Bellare-Garay-Rabin, EUROCRYPT'98]:
prod_s lhs_s^{g_s} == prod_s rhs_s^{g_s} with fresh verifier-sampled 128-bit
g_s (os.urandom, never Fiat-Shamir).  The gamma-weighted products reduce
over the sessions axis on the device (ModCtx.pow_prod_axis0: K1 with the
axis-0 fold).  A failing batched check replays the per-session verifiers to
attribute blame, exactly as the reference does.

TPU_MPC_TORCH_BATCH_VERIFY: "1" forces the batched checks on, "0" off;
unset enables them at S >= 8 sessions.

Multi-tenant serving (G key groups interleaved over the sessions axis,
session s on group s % G) keeps one batched product per group: _grouping
finds G from the key batch's n_groups hint and verifies that the moduli and
bases really repeat with period G.  STATS counts which path each call took.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.modctx import host_mulmod, resolve
from ..sharding import mesh as sharding
from .pdl_slack import (
    PDLwSlackProofBatch,
    PDLwSlackStatementBatch,
    _pdl_host_ec_checks,
    pdl_slack_verify,
)
from .range_proofs import (
    E_BITS,
    AliceProofBatch,
    DlogStatementBatch,
    PaillierCtxBatch,
    _alice_host_checks,
    alice_verify,
)

GAMMA_BITS = 128
_MIN_SESSIONS = 8  # below this the per-session path is cheaper (launch cost)

# calls since the last reset_stats(): "grouped" counts the batched checks by
# their group count G, "per_session" the calls that ran the per-session
# verifier (batching off or not applicable, or a failed batched equation)
STATS = {"grouped": {}, "per_session": 0}


def reset_stats() -> None:
    STATS["grouped"] = {}
    STATS["per_session"] = 0


def _per_session(fn, *args):
    STATS["per_session"] += 1
    return fn(*args)


def _grouped(G: int, ok):
    STATS["grouped"][G] = STATS["grouped"].get(G, 0) + 1
    return ok


def _enabled(S: int) -> bool:
    # read per call (not at import): TPU_MPC_TORCH_BATCH_VERIFY is a
    # security-relevant opt-out and must work regardless of import order
    env = os.environ.get("TPU_MPC_TORCH_BATCH_VERIFY")
    if env is not None:
        return env == "1"
    return S >= _MIN_SESSIONS


def _shared_axis0(shape, *arrays) -> bool:
    """True iff every array is constant along the leading (sessions) axis
    once broadcast to `shape` — the precondition for sharing moduli/bases
    across the batched product."""
    if len(shape) < 1 or shape[0] < 2:
        return False
    for a in arrays:
        b = np.broadcast_to(np.asarray(a, dtype=object), shape)
        first = b[0]
        for s in range(1, shape[0]):
            if not np.array_equal(b[s], first):
                return False
    return True


def _grouping(shape, n_groups: int, *arrays):
    """-> G such that the sessions axis splits into S/G x G blocks with
    moduli/bases constant within each of the G columns (G=1: fully shared;
    the interleaved multi-tenant layout has group(s) = s % G), or None.
    n_groups is the layout hint carried by the key batch (repeat_interleaved)
    — the sharing is still VERIFIED, never assumed."""
    S = shape[0] if len(shape) >= 1 else 0
    if S < 2:
        return None
    if _shared_axis0(shape, *arrays):
        return 1
    G = int(n_groups)
    if G > 1 and S % G == 0 and S // G >= 2:
        gshape = (S // G, G) + tuple(shape[1:])
        resh = [
            np.broadcast_to(np.asarray(a, dtype=object), shape).reshape(gshape)
            for a in arrays
        ]
        if _shared_axis0(gshape, *resh):
            return G
    return None


def sample_gammas(shape) -> np.ndarray:
    """Verifier-side batching exponents: fresh unpredictable 128-bit ints
    (os.urandom), sampled AFTER the proofs are fixed.  Not Fiat-Shamir —
    these never leave the verifier.  Under a sessions mesh over ranks, rank
    0 draws them and every rank takes its bytes, so that the ranks' sharded
    launches agree."""
    count = int(np.prod(shape)) if shape else 1
    raw = os.urandom(count * (GAMMA_BITS // 8))
    mesh = sharding.current_mesh()
    if mesh is not None and mesh.group is not None:
        raw = mesh.broadcast_bytes(raw)
    w = GAMMA_BITS // 8
    out = np.empty(count, dtype=object)
    for i in range(count):
        out[i] = int.from_bytes(raw[i * w:(i + 1) * w], "big")
    return out.reshape(shape)


def _sum_axis0(g, x) -> np.ndarray:
    """sum_s g_s * x_s over the leading axis (object ints, no reduction)."""
    prod = np.asarray(g, dtype=object) * np.asarray(x, dtype=object)
    return np.sum(prod, axis=0, keepdims=True)


def _log2ceil(S: int) -> int:
    return max(1, (S - 1).bit_length())


def alice_verify_fast(
    proof: AliceProofBatch, cipher, ek: PaillierCtxBatch, stmt: DlogStatementBatch
) -> np.ndarray:
    """alice_verify with the cross-session batched equation checks when the
    sessions axis shares one key set; transparent per-session fallback
    otherwise (distinct keys, tiny batches, or a failing batched check)."""
    shape = np.broadcast_shapes(
        np.shape(proof.z), stmt.ctx.batch_shape, ek.n_ctx.batch_shape, np.shape(cipher)
    )
    S = shape[0] if len(shape) >= 1 else 0
    G = _grouping(
        shape, max(stmt.n_groups, ek.n_groups),
        stmt.ctx.n_ints, stmt.h1, stmt.h2, ek.n,
    ) if _enabled(S) else None
    if G is None:
        return _per_session(alice_verify, proof, cipher, ek, stmt)

    # sessions axis viewed as (R, G): reductions run over R, keeping one
    # product per key group (G=1 == the fully-shared serving pattern)
    R = S // G
    resh = lambda a: np.broadcast_to(
        np.asarray(a, dtype=object), shape
    ).reshape((R, G) + shape[1:])
    tb = stmt.ctx.bits
    cheap_ok, (e, s1, s2) = _alice_host_checks(proof, cipher, ek, stmt, shape)

    # sessions already failed by the host checks are excluded (g_s = 0, so
    # x^0 = 1 drops out of every product) — they are blamed by cheap_ok and
    # must not force the equation fallback
    g = resh(sample_gammas(shape) * cheap_ok)

    # gamma-weighted products, reduced over the R axis ON DEVICE
    # (ModCtx.pow_prod_axis0): prod (w z^e)^g = (prod w^g)(prod z^(ge)) etc.
    # — only [1, G, ...] slots cross to the host, so the per-launch decode
    # of S values (the dominant host cost of the first batched-verify cut)
    # disappears; all dispatches async
    nt_ctx = stmt.ctx.reshape_lead(R, G)
    nn_ctx = ek.nn_ctx.reshape_lead(R, G)
    ge = g * resh(e)
    wg_l = nt_ctx.pow_prod_axis0(resh(proof.w), g, GAMMA_BITS, sync=False)
    zge_l = nt_ctx.pow_prod_axis0(resh(proof.z), ge, GAMMA_BITS + E_BITS, sync=False)
    ug_l = nn_ctx.pow_prod_axis0(resh(proof.u), g, GAMMA_BITS, sync=False)
    cge_l = nn_ctx.pow_prod_axis0(resh(cipher), ge, GAMMA_BITS + E_BITS, sync=False)
    sg_l = nn_ctx.pow_prod_axis0(resh(proof.s), g, GAMMA_BITS, sync=False)

    # collapsed RHSs at one representative session per group (sessions
    # 0..G-1 in the interleaved layout); the leading reduced axis is
    # dropped so G=1 keeps the legacy (1,)+rest call shapes
    red = lambda l: np.asarray(resolve(l), dtype=object)[0]
    ek0 = ek.take(np.arange(G), 0)
    stmt0 = stmt.take(np.arange(G), 0)
    eb_sum = GAMMA_BITS + _log2ceil(R)
    E1 = _sum_axis0(g, resh(s1))[0]              # < 2^(776 + eb_sum)
    E2 = _sum_axis0(g, resh(s2))[0]              # < 2^(768 + tb + 16 + eb_sum)
    rhs_w0_l = stmt0.pow_h1h2(
        E1, E2, hints=(776 + eb_sum, 768 + tb + 16 + eb_sum), sync=False
    )
    P_s = red(sg_l)
    rhs_u0_l = ek0.nn_ctx.pow(P_s, ek0.n, ebits_hint=ek.n_ctx.bits, sync=False)

    gshape1 = (G,) + shape[1:]
    ntg = resh(stmt.ctx.n_ints)[0]
    nng = resh(ek.nn)[0]
    P_w = host_mulmod(red(wg_l), red(zge_l), ntg)
    P_u = host_mulmod(red(ug_l), red(cge_l), nng)
    n0 = np.broadcast_to(ek0.n, gshape1)
    lin = host_mulmod(E1, np.ones_like(n0), n0) * n0 + 1  # 1 + N (sum g s1) mod N^2
    rhs_u0 = host_mulmod(resolve(rhs_u0_l), lin, np.broadcast_to(ek0.nn, gshape1))

    eq_ok = np.array_equal(P_w, np.asarray(resolve(rhs_w0_l), dtype=object)) and \
        np.array_equal(P_u, np.asarray(rhs_u0, dtype=object))
    if eq_ok:
        return _grouped(G, cheap_ok)
    # a batched equation failed: replay per-session to attribute blame
    # (see module docstring — this is the <= 1/2-survival cheat path)
    return _per_session(alice_verify, proof, cipher, ek, stmt)


def pdl_slack_verify_fast(
    proof: PDLwSlackProofBatch, stmt: PDLwSlackStatementBatch
) -> np.ndarray:
    """pdl_slack_verify with cross-session batched u2/u3 equation checks
    (the EC u1 identity stays per-session — its bases R, R_bar are
    session-specific); transparent per-session fallback otherwise."""
    shape = np.broadcast_shapes(
        np.shape(proof.z), stmt.dlog.ctx.batch_shape, stmt.ek.n_ctx.batch_shape
    )
    S = shape[0] if len(shape) >= 1 else 0
    G = _grouping(
        shape, max(stmt.dlog.n_groups, stmt.ek.n_groups),
        stmt.dlog.ctx.n_ints, stmt.dlog.h1, stmt.dlog.h2, stmt.ek.n,
    ) if _enabled(S) else None
    if G is None:
        return _per_session(pdl_slack_verify, proof, stmt)

    R = S // G
    resh = lambda a: np.broadcast_to(
        np.asarray(a, dtype=object), shape
    ).reshape((R, G) + shape[1:])
    tb = stmt.dlog.ctx.bits
    e, s1, s3, cheap_ok = _pdl_host_ec_checks(proof, stmt, shape)
    g = resh(sample_gammas(shape) * cheap_ok)

    nt_ctx = stmt.dlog.ctx.reshape_lead(R, G)
    nn_ctx = stmt.ek.nn_ctx.reshape_lead(R, G)
    ge = g * resh(e)
    u2g_l = nn_ctx.pow_prod_axis0(resh(proof.u2), g, GAMMA_BITS, sync=False)
    cge_l = nn_ctx.pow_prod_axis0(
        resh(stmt.ciphertext), ge, GAMMA_BITS + E_BITS, sync=False
    )
    u3g_l = nt_ctx.pow_prod_axis0(resh(proof.u3), g, GAMMA_BITS, sync=False)
    zge_l = nt_ctx.pow_prod_axis0(
        resh(proof.z), ge, GAMMA_BITS + E_BITS, sync=False
    )
    s2g_l = nn_ctx.pow_prod_axis0(resh(proof.s2), g, GAMMA_BITS, sync=False)

    red = lambda l: np.asarray(resolve(l), dtype=object)[0]
    ek0 = stmt.ek.take(np.arange(G), 0)
    dlog0 = stmt.dlog.take(np.arange(G), 0)
    eb_sum = GAMMA_BITS + _log2ceil(R)
    E1 = _sum_axis0(g, resh(s1))[0]
    E3 = _sum_axis0(g, resh(s3))[0]
    rhs_u30_l = dlog0.pow_h1h2(
        E1, E3, hints=(776 + eb_sum, 768 + tb + 16 + eb_sum), sync=False
    )
    P_s2 = red(s2g_l)
    rhs_u20_l = ek0.nn_ctx.pow(P_s2, ek0.n, ebits_hint=stmt.ek.n_ctx.bits, sync=False)

    gshape1 = (G,) + shape[1:]
    P_u2 = host_mulmod(red(u2g_l), red(cge_l), resh(stmt.ek.nn)[0])
    P_u3 = host_mulmod(
        red(u3g_l), red(zge_l), resh(stmt.dlog.ctx.n_ints)[0]
    )
    n0 = np.broadcast_to(ek0.n, gshape1)
    lin = host_mulmod(E1, np.ones_like(n0), n0) * n0 + 1
    rhs_u20 = host_mulmod(
        resolve(rhs_u20_l), lin, np.broadcast_to(ek0.nn, gshape1)
    )

    eq_ok = np.array_equal(P_u3, np.asarray(resolve(rhs_u30_l), dtype=object)) and \
        np.array_equal(P_u2, np.asarray(rhs_u20, dtype=object))
    if eq_ok:
        return _grouped(G, cheap_ok)
    return _per_session(pdl_slack_verify, proof, stmt)
