"""GG20 {t,n}-threshold ECDSA with identifiable aborts, session-batched
(port of tpu_mpc/protocols/gg20/batch.py: keygen, key refresh and update,
signing with its fault-injection seams, and the encrypted share backup).

  keygen   4 rounds: ring-Pedersen setup (h1, h2, N_tilde), correct-key
           proof, composite-dlog proofs both directions, Paillier bit-length
           policing, Feldman VSS, dlog proofs of the x_i
  offline  6 rounds: MtA with Alice range proofs, T_i Pedersen commitments,
           R / R_bar + PDLwSlack, S_i + HomoElGamal consistency
  online   1 round: s_i broadcast

Per-check boolean masks fold onto the culpable party like the reference's
ErrorType { error_type, bad_actors }; blame.py replays the revealed state
of an aborted session to name the cheater.  keygen draws from SessionRng in
the reference's order and its primes are the reference's (host/primes.py),
so a pinned seed gives the reference's keys value for value.

Fault injection (gg_2020/test.rs's corruption scenarios): offline_stage's
corrupt={"step": 5 | 6 | "decommit", "parties": spec} doubles delta_i,
sigma_i or the committed g_gamma of the listed parties; sign_online's
{"step": 7, ...} doubles s_i.  spec is a flat list of signer slots (every
session) or one list per session (the sessions axis as the scenario axis;
[] is an honest session).

Serving: tile_key serves one key set over S sessions; repeat_key serves G
key sets (take_key_sets of a keygen batch) over S sessions interleaved,
session s on key group s % G, with the tables compressed at G groups.

Two configurations, selected by TPU_MPC_TORCH_ENC_TABLES
(zk/range_proofs.py:enc_tables_enabled; unset = tables on the card, none on
the CPU):
  tables   the JAX package's default on an accelerator: key_from_material
           builds the h1/h2 tables and the randomizer tables once on the
           pre-tile key, tile_key shares them, and every ring-Pedersen
           commitment, r^N and folded response s = g^(r_t e + t_beta) is a
           fixed-base product (kernel K2);
  uniform  no tables: ring-Pedersen products through ModCtx.pow_prod (K1),
           uniform encryption randomizers (the reference's
           TPU_MPC_ENC_TABLES=0).
Cross-session batch verification is on at S >= 8 in both
(zk/batch_verify.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.limbs import batch_from_limbs
from ...core.modctx import LazyMap, ModCtx
from ...device import resolve_device, to_numpy
from ...ec import secp256k1 as dec
from ...hashes.fiat_shamir import commit_rows, point_hash_ints
from ...host import ec as hec, primes
from ...mta import mta
from ...paillier import paillier as dp
from ...utils.rng import SessionRng
from ...vss import feldman
from ...zk import sigma
from ...zk.batch_verify import alice_verify_fast, pdl_slack_verify_fast
from ...zk.paillier_zk import (
    CompositeDLogStatementBatch,
    composite_dlog_prove,
    composite_dlog_verify,
    correct_key_prove,
    correct_key_verify,
)
from ...zk.pdl_slack import PDLwSlackStatementBatch, pdl_slack_prove
from ...zk.range_proofs import DlogStatementBatch, PaillierCtxBatch, alice_prove
from ..gg18.batch import _dk_take, _finish_signatures, _sc, gen_paillier_batch

Q = hec.N
SECURITY = 256
PAILLIER_MIN_BITS = 2047  # party_i.rs:49
PAILLIER_MAX_BITS = 2048  # party_i.rs:50


def generate_h1_h2_n_tilde_batch(S: int, n: int, bits: int, rng: SessionRng, device=None):
    """Ring-Pedersen setup per slot (party_i.rs:137-156): host primes, then
    h2 = h1^xhi mod N_tilde for every slot in one K1 launch."""
    pt, qt = gen_paillier_batch(S, n, bits, rng)
    n_tilde = pt * qt
    phi = (pt - 1) * (qt - 1)
    h1 = rng.below(n_tilde, (S, n))
    xhi0 = np.empty((S, n), dtype=object)
    xhi_inv0 = np.empty((S, n), dtype=object)
    for s in range(S):
        for i in range(n):
            ph = int(phi[s, i])
            while True:
                x = rng._r.randrange(ph)
                try:
                    inv = pow(x, -1, ph)
                    break
                except ValueError:
                    continue
            xhi0[s, i] = x
            xhi_inv0[s, i] = inv
    ctx = ModCtx.from_ints(n_tilde, bits, device)
    h2 = ctx.pow(h1, xhi0, bits)
    xhi = phi - xhi0          # party_i.rs:152-153
    xhi_inv = phi - xhi_inv0
    return ctx, h1, h2, xhi, xhi_inv, phi


@dataclasses.dataclass
class LocalKeyBatch20:
    S: int
    t: int
    n: int
    paillier_bits: int
    p: np.ndarray
    q: np.ndarray
    ek: PaillierCtxBatch          # [S, n]
    dk: dp.BatchDecryptionKey
    dlog_stmt: DlogStatementBatch  # [S, n] (h1, h2, N_tilde per party)
    u: np.ndarray
    x: np.ndarray
    y: dec.Point
    y_i: dec.Point
    vss: feldman.VssSchemeBatch

    @property
    def device(self):
        return self.ek.n_ctx.device


@dataclasses.dataclass
class KeygenResult20:
    key: LocalKeyBatch20
    ok: np.ndarray            # [S] every check of the session passed
    bad_actors: np.ndarray    # [S, n] the parties a failed check points at


def _bit_length_ok(ints, lo: int, hi: int) -> np.ndarray:
    return np.vectorize(lambda v: lo <= int(v).bit_length() <= hi, otypes=[bool])(ints)


def keygen(S: int, t: int, n: int, rng: SessionRng, paillier_bits: int = 2048,
           corrupt: dict | None = None, safe_primes: bool = False,
           device=None) -> KeygenResult20:
    """GG20 {t,n} keygen for S independent key sets (rounds 1-4 of
    party_i.rs), every party of every set at once.  Draws from rng in the
    reference's order: u, the Paillier seeds, the N_tilde seeds, h1, the
    xhi rejection loop, blind, the two composite-dlog r, the Feldman
    coefficients, the dlog nonces.

    safe_primes=True draws the Paillier factors as safe primes
    (Keys::create_safe_prime); N_tilde stays on random primes either way, as
    in the reference.  corrupt={"small_paillier": [i, ...]}: those parties
    present a Paillier modulus of half the width, with honest proofs for
    it, so only the bit-length policy must catch them.  In the tables
    configuration the key's h1/h2 and randomizer tables are built at the
    end, on the key batch before any tiling."""
    dev = resolve_device(device)
    sc = lambda v: _sc(v, dev)
    u = rng.scalars((S, n))
    y_i = dec.mul_generator(sc(u))
    p_fac, q_fac = gen_paillier_batch(S, n, paillier_bits, rng, safe=safe_primes)
    if corrupt and corrupt.get("small_paillier"):
        for pi in corrupt["small_paillier"]:
            for s in range(S):
                p_fac[s, pi] = primes.gen_prime(paillier_bits // 4, rng._r)
                q_fac[s, pi] = primes.gen_prime(paillier_bits // 4, rng._r)
    ns = p_fac * q_fac
    ek = PaillierCtxBatch.from_ints(ns, paillier_bits, dev).attach_sk(p_fac, q_fac)
    dk = dp.BatchDecryptionKey.from_ints(p_fac, q_fac, paillier_bits)
    nt_ctx, h1, h2, xhi, xhi_inv, _ = generate_h1_h2_n_tilde_batch(
        S, n, paillier_bits, rng, dev)
    dlog_stmt = DlogStatementBatch(ctx=nt_ctx, h1=h1, h2=h2)

    # round 1 broadcast: com(y_i), correct-key, composite-dlog both ways
    blind = rng.bits(SECURITY, (S, n))
    y_ints = point_hash_ints(y_i)
    com = commit_rows(y_ints, blind)
    ck_proof = correct_key_prove(ek.n_ctx, (p_fac - 1) * (q_fac - 1))
    stmt_h1 = CompositeDLogStatementBatch(ctx=nt_ctx, g=h1, ni=h2)
    stmt_h2 = CompositeDLogStatementBatch(ctx=nt_ctx, g=h2, ni=h1)
    cd_proof_h1 = composite_dlog_prove(stmt_h1, xhi, rng)
    cd_proof_h2 = composite_dlog_prove(stmt_h2, xhi_inv, rng)

    # round 2: verify everything (party_i.rs:260-320)
    com_ok = commit_rows(y_ints, blind) == com
    ck_ok = correct_key_verify(ck_proof, ek.n_ctx)
    cd_ok = (composite_dlog_verify(cd_proof_h1, stmt_h1)
             & composite_dlog_verify(cd_proof_h2, stmt_h2))
    lo, hi = ((PAILLIER_MIN_BITS, PAILLIER_MAX_BITS) if paillier_bits == 2048
              else (paillier_bits - 1, paillier_bits))
    bitlen_ok = _bit_length_ok(ns, lo, hi) & _bit_length_ok(nt_ctx.n_ints, lo, hi)

    vss, shares = feldman.share(t, n, u, rng, dev)

    # round 3: share validation, x_i, dlog proof
    vss_ok = np.ones((S, n), dtype=bool)
    for j in range(n):
        vss_ok &= feldman.validate_share(vss, shares[:, :, j], j)
    c0_ok = to_numpy(dec.point_eq(feldman.point_index(vss.commitments, 0), y_i))
    x = np.mod(np.sum(shares, axis=1), Q)
    y = dec.point_sum(y_i, axis=1)
    dlog_proofs = sigma.dlog_prove(sc(x), rng)

    # round 4: the dlog proofs, and each pk_j against the VSS commitments
    dlog_ok = sigma.dlog_verify(dlog_proofs)
    xi_ok = np.ones((S, n), dtype=bool)
    for j in range(n):
        xi_com = dec.point_sum(feldman.commitment_eval(vss, j), axis=1)   # [S]
        pk_j = dec.point_index_axis(dlog_proofs.pk, j, 1)
        xi_ok[:, j] = to_numpy(dec.point_eq(xi_com, pk_j))

    bad = ~(com_ok & ck_ok & cd_ok & bitlen_ok & vss_ok & c0_ok & dlog_ok & xi_ok)
    # the tables of the tables configuration, built while the key batch is
    # small (before any tiling): a no-op in the uniform configuration
    dlog_stmt.ensure_tables()
    ek.ensure_enc_tables()
    key = LocalKeyBatch20(
        S=S, t=t, n=n, paillier_bits=paillier_bits, p=p_fac, q=q_fac, ek=ek, dk=dk,
        dlog_stmt=dlog_stmt, u=u, x=x, y=y, y_i=y_i, vss=vss,
    )
    return KeygenResult20(key=key, ok=~bad.any(axis=1), bad_actors=bad)


def refresh_private_key(key: LocalKeyBatch20, factor_ints, rng: SessionRng,
                        safe_primes: bool = False) -> LocalKeyBatch20:
    """Proactive key rotation (party_i.rs:459-499): u_i += factor, and a
    fresh Paillier keypair and ring-Pedersen setup per slot (random primes,
    or safe Paillier primes with safe_primes=True).  factor_ints [S, n]: a
    refresh ceremony supplies zero-sum factors so that y is unchanged; like
    the reference, this applies whatever it is given.  The new h1/h2
    tables are built in the tables configuration; the randomizer tables are
    not (as in the reference)."""
    S, n, bits, dev = key.S, key.n, key.paillier_bits, key.device
    u_new = np.mod(key.u + np.mod(np.asarray(factor_ints, dtype=object), Q), Q)
    y_i_new = dec.mul_generator(_sc(u_new, dev))
    p_fac, q_fac = gen_paillier_batch(S, n, bits, rng, safe=safe_primes)
    nt_ctx, h1, h2, _, _, _ = generate_h1_h2_n_tilde_batch(S, n, bits, rng, dev)
    stmt = DlogStatementBatch(ctx=nt_ctx, h1=h1, h2=h2).ensure_tables()
    return dataclasses.replace(
        key, u=u_new, y_i=y_i_new, y=dec.point_sum(y_i_new, axis=1), p=p_fac, q=q_fac,
        ek=PaillierCtxBatch.from_ints(p_fac * q_fac, bits, dev).attach_sk(p_fac, q_fac),
        dk=dp.BatchDecryptionKey.from_ints(p_fac, q_fac, bits), dlog_stmt=stmt,
    )


def update_private_key(key: LocalKeyBatch20, factor_u, factor_x) -> LocalKeyBatch20:
    """PartyPrivate::update_private_key (party_i.rs:513-523): additive
    update of u_i and x_i; Paillier and ring-Pedersen untouched."""
    u_new = np.mod(key.u + np.asarray(factor_u, dtype=object), Q)
    x_new = np.mod(key.x + np.asarray(factor_x, dtype=object), Q)
    y_i_new = dec.mul_generator(_sc(u_new, key.device))
    return dataclasses.replace(key, u=u_new, x=x_new, y_i=y_i_new,
                               y=dec.point_sum(y_i_new, axis=1))


def to_encrypted_segments(key: LocalKeyBatch20, segment_size: int, num_segments: int, pub_y,
                          rng: SessionRng):
    """Verifiable backup of every u_i share (party_i.rs:503-511): the same
    segmentation as GG18's (host/backup.py) -> (witnesses, encrypted
    segment lists), flattened [S * n] row-major."""
    from ...host import backup

    return backup.backup_batch(key.u, segment_size, num_segments, pub_y, rng)


def _ints(v) -> np.ndarray:
    """Nested lists of ints or decimal strings -> object int array."""
    return np.vectorize(int, otypes=[object])(np.asarray(v, dtype=object))


def _tuplify(v):
    """JSON point lists ([x, y] leaves, ints or strings; None = infinity)
    -> the (x, y)-tuple leaves points_from_host takes."""
    if v is None:
        return None
    if isinstance(v, (list, tuple)) and len(v) == 2 and isinstance(v[0], (int, str)):
        return (int(v[0]), int(v[1]))
    return [_tuplify(e) for e in v]


def _host_points(P):
    """Limb arrays of a Jacobian point batch (any array type with
    np.asarray) -> nested affine tuples, computed with python ints."""
    X, Y, Z = (np.asarray(batch_from_limbs(np.asarray(c)), dtype=object) for c in P)
    out = np.empty(X.shape, dtype=object).reshape(-1)
    for i, (x, y, z) in enumerate(zip(X.reshape(-1), Y.reshape(-1), Z.reshape(-1))):
        x, y, z = int(x), int(y), int(z)
        if z % hec.P == 0:
            out[i] = None
        else:
            zi = pow(z, -1, hec.P)
            out[i] = (x * zi * zi % hec.P, y * zi * zi * zi % hec.P)
    return out.reshape(X.shape).tolist()


def key_from_material(src, device=None) -> LocalKeyBatch20:
    """The port's LocalKeyBatch20 from the reference's key material: either
    the plain-int dict of benches/bench_key_2048.json / tests/fixtures/
    gg20key_*.json (ints or decimal strings; S defaults to 1), or a
    tpu_mpc LocalKeyBatch20 object (read through its numpy-convertible
    fields).  Builds every device context on `device` (default "cuda"), and
    in the tables configuration the h1/h2 and randomizer tables."""
    dev = resolve_device(device)
    if isinstance(src, dict):
        d = src
        S, t, n, bits = d.get("S", 1), d["t"], d["n"], d["bits"]
        p, q = _ints(d["p"]), _ints(d["q"])
        nt, h1, h2 = _ints(d["nt"]), _ints(d["h1"]), _ints(d["h2"])
        u, x = _ints(d["u"]), _ints(d["x"])
        y_i_h, vss_h = _tuplify(d["y_i"]), _tuplify(d["vss"])
    else:
        S, t, n, bits = src.S, src.t, src.n, src.paillier_bits
        p, q = _ints(src.p), _ints(src.q)
        st = src.dlog_stmt
        nt, h1, h2 = _ints(st.ctx.n_ints), _ints(st.h1), _ints(st.h2)
        u, x = _ints(src.u), _ints(src.x)
        y_i_h, vss_h = _host_points(src.y_i), _host_points(src.vss.commitments)
    y_i = dec.points_from_host(y_i_h, dev)
    # the tables of the tables configuration, built once while the key batch
    # is small (before tile_key), as the reference's keygen does
    ek = PaillierCtxBatch.from_ints(p * q, bits, dev).attach_sk(p, q).ensure_enc_tables()
    dlog_stmt = DlogStatementBatch.from_ints(nt, h1, h2, bits, dev).ensure_tables()
    return LocalKeyBatch20(
        S=S, t=t, n=n, paillier_bits=bits, p=p, q=q,
        ek=ek, dk=dp.BatchDecryptionKey.from_ints(p, q, bits), dlog_stmt=dlog_stmt,
        u=u, x=x, y=dec.point_sum(y_i, axis=1), y_i=y_i,
        vss=feldman.VssSchemeBatch(t=t, n=n, commitments=dec.points_from_host(vss_h, dev)),
    )


def tile_key(key1: LocalKeyBatch20, S: int) -> LocalKeyBatch20:
    """Broadcast a 1-session key batch across S sessions (the serving
    pattern of one signer group).  The tables are shared, not copied."""
    tile_np = lambda a: np.broadcast_to(a, (S,) + a.shape[1:]).copy()
    tile_pt = lambda P: dec.Point(*(c.expand((S,) + tuple(c.shape[1:])) for c in P))
    return LocalKeyBatch20(
        S=S, t=key1.t, n=key1.n, paillier_bits=key1.paillier_bits,
        p=tile_np(key1.p), q=tile_np(key1.q),
        ek=key1.ek.tile(S), dk=key1.dk.map(tile_np),
        dlog_stmt=key1.dlog_stmt.tile(S),
        u=tile_np(key1.u), x=tile_np(key1.x),
        y=tile_pt(key1.y), y_i=tile_pt(key1.y_i),
        vss=feldman.VssSchemeBatch(t=key1.vss.t, n=key1.vss.n,
                                   commitments=tile_pt(key1.vss.commitments)),
    )


def take_key_sets(key: LocalKeyBatch20, G: int) -> LocalKeyBatch20:
    """The first G key sets of a key batch (e.g. a keygen of S >= G sets),
    as the JAX package's multi-tenant bench loads them
    (benches/group_bench.py:_load_group_key).  The tables are sliced along
    with the key sets, not rebuilt."""
    if not 1 <= G <= key.S:
        raise ValueError(f"take_key_sets: G = {G} outside [1, {key.S}]")
    idx = np.arange(G)
    first = lambda a: a[:G]
    pt = lambda P: dec.Point(*(c[:G] for c in P))
    return LocalKeyBatch20(
        S=G, t=key.t, n=key.n, paillier_bits=key.paillier_bits,
        p=first(key.p), q=first(key.q), ek=key.ek.take(idx, 0), dk=key.dk.map(first),
        dlog_stmt=key.dlog_stmt.take(idx, 0), u=first(key.u), x=first(key.x),
        y=pt(key.y), y_i=pt(key.y_i),
        vss=feldman.VssSchemeBatch(t=key.vss.t, n=key.vss.n, commitments=pt(key.vss.commitments)),
    )


def repeat_key(keyG: LocalKeyBatch20, S: int) -> LocalKeyBatch20:
    """A G-key-set batch -> S sessions, interleaved: session s uses key
    group s % G (multi-tenant serving, benches/group_bench.py:_repeat_key).
    The tables stay compressed at G groups behind the gmap, and the batch
    verification keeps one product per group."""
    G = keyG.S
    if S % G:
        raise ValueError(f"repeat_key: S = {S} is not a multiple of G = {G}")
    R = S // G
    rep_np = lambda a: np.tile(a, (R,) + (1,) * (a.ndim - 1))
    rep_pt = lambda P: dec.Point(*(c.repeat((R,) + (1,) * (c.dim() - 1)) for c in P))
    return LocalKeyBatch20(
        S=S, t=keyG.t, n=keyG.n, paillier_bits=keyG.paillier_bits,
        p=rep_np(keyG.p), q=rep_np(keyG.q),
        ek=keyG.ek.repeat_interleaved(R), dk=keyG.dk.map(rep_np),
        dlog_stmt=keyG.dlog_stmt.repeat_interleaved(R),
        u=rep_np(keyG.u), x=rep_np(keyG.x), y=rep_pt(keyG.y), y_i=rep_pt(keyG.y_i),
        vss=feldman.VssSchemeBatch(t=keyG.vss.t, n=keyG.vss.n,
                                   commitments=rep_pt(keyG.vss.commitments)),
    )


def _peer_idx(tp: int):
    """Rotation packing for the off-diagonal pair layout: slot (i, kk) is
    the pair (alice i, bob peers[i, kk] = (i+1+kk) mod tp); iinv is the
    inverse map: peers[iinv[j, kk], kk] == j."""
    peers = np.asarray([[(i + 1 + kk) % tp for kk in range(tp - 1)] for i in range(tp)])
    iinv = np.asarray([[(j - 1 - kk) % tp for kk in range(tp - 1)] for j in range(tp)])
    return peers, iinv


def _unpack_dense(packed: np.ndarray, peers: np.ndarray, fill) -> np.ndarray:
    """Packed [S, tp, tp-1] -> dense [S, alice, bob] with `fill` diagonal."""
    S_, tp = packed.shape[0], packed.shape[1]
    dense = np.full((S_, tp, tp), fill, dtype=object)
    for i in range(tp):
        for kk in range(tp - 1):
            dense[:, i, peers[i, kk]] = packed[:, i, kk]
    return dense


@dataclasses.dataclass
class OfflineState:
    """CompletedOfflineStage analog + blame inputs."""

    s_parties: list[int]
    R: dec.Point                  # [S]
    r_x: np.ndarray               # [S]
    k: np.ndarray                 # [S, tp] (secret)
    sigma_i: np.ndarray           # [S, tp] (secret)
    delta_i: np.ndarray
    y: dec.Point
    ok: np.ndarray                # [S]
    bad_actors: np.ndarray        # [S, tp]
    k_randomness: object          # [S, tp] ints, or a DeferredLaunch (tables)
    gamma: np.ndarray
    beta_g: np.ndarray            # [S, alice, bob]
    beta_randomness: object       # dense ints, or a LazyMap of a DeferredLaunch
    beta_tag: np.ndarray
    alpha: np.ndarray
    msg_a_c: np.ndarray           # [S, tp] k ciphertexts
    msg_b_gamma_c: np.ndarray     # [S, alice, bob]
    R_bar: dec.Point              # [S, tp]
    S_i: dec.Point                # [S, tp]
    T_i: dec.Point
    l_i: np.ndarray
    m_b_w_c: np.ndarray = None
    miu: np.ndarray = None
    ni: np.ndarray = None
    debug_masks: dict = None
    g_gamma_decommit: dec.Point = None

    def scrub(self) -> None:
        """Zeroize the one-time secrets in place after a successful sign."""
        from ...utils.ct import scrub_array

        scrub_array(self.k, self.sigma_i, self.delta_i, self.k_randomness, self.gamma,
                    self.beta_g, self.beta_randomness, self.beta_tag, self.alpha,
                    self.miu, self.ni, self.l_i)


def _corrupt_slots(parties, S: int):
    """Yield (session index or slice, party slot) pairs of a corrupt spec:
    a flat list = the same slots in every session; a list of lists = one
    list per session."""
    if parties and isinstance(parties[0], (list, tuple)):
        for b, ps in enumerate(parties):
            for pi in ps:
                yield b, pi
    else:
        for pi in parties:
            yield slice(None), pi


def _double_mod_q(arr, b, pi):
    """arr[b, pi] := 2 arr[b, pi] mod Q in an object array: a single cell
    comes back as a bare python int (np.mod on it overflows C long)."""
    v = arr[b, pi]
    if isinstance(v, np.ndarray):
        arr[b, pi] = np.mod(v * 2, Q)
    else:
        arr[b, pi] = (int(v) * 2) % Q


def offline_stage(key: LocalKeyBatch20, s_parties: list[int], rng: SessionRng,
                  corrupt: dict | None = None) -> OfflineState:
    """Rounds 0-6 of GG20 signing (message-independent offline phase).

    corrupt: optional fault injection (module docstring).  Step 5 doubles
    delta_i, step 6 sigma_i (gg_2020/test.rs:459-465); "decommit" makes a
    party commit and decommit consistently to a fake g_gamma = 2 gamma G
    while its MtA uses the true gamma, so that only phase-5 blame's
    decommit re-check names it.  The reference's decommit seam takes a flat
    list only (it indexes every session); the port takes per-session lists
    there too."""
    S = key.S
    tp = len(s_parties)
    dev = key.device
    sc = lambda v: _sc(v, dev)
    # h1/h2 tables: a no-op when built at load, outside the tables
    # configuration, or for a statement batch too large for tables
    key.dlog_stmt.ensure_tables()

    lam = np.asarray([feldman.lagrange_coeff(i, s_parties) for i in s_parties], dtype=object)
    x_s = key.x[:, s_parties]
    w = np.mod(x_s * lam[None, :], Q)
    g_w = dec.mul_generator(sc(w))
    k = rng.scalars((S, tp))
    gamma = rng.scalars((S, tp))
    g_gamma = dec.mul_generator(sc(gamma))
    step = corrupt.get("step") if corrupt else None
    if step == "decommit":
        fake = gamma.copy()
        for b, pi in _corrupt_slots(corrupt["parties"], S):
            _double_mod_q(fake, b, pi)
        g_gamma_dec = dec.mul_generator(sc(fake))
    else:
        g_gamma_dec = g_gamma

    blind1 = rng.bits(SECURITY, (S, tp))
    gg_dec_ints = point_hash_ints(g_gamma_dec)
    com1 = commit_rows(gg_dec_ints, blind1)

    ek_s = key.ek.take(s_parties, 1)
    stmt_s = key.dlog_stmt.take(s_parties, 1)         # [S, tp]
    # MessageA: alice i encrypts k_i, proving range to each peer j's stmt.
    # With the randomizer tables, (r_a, r_a^N) come squaring-free and r_a
    # itself stays a deferred launch: the proofs fold its table exponent
    # r_a_t instead, and only a blame replay materializes r_a
    rn_a = r_a_t = None
    if ek_s.enc_tab_g is not None:
        r_a, rn_a, r_a_t = ek_s.sample_unit_with_power(
            (S, tp), rng, sync=False, defer_value=True, want_t=True)
    else:
        r_a = rng.below(np.broadcast_to(ek_s.n, (S, tp)), (S, tp))
    # off-diagonal packed pair layout [S, alice, tp-1]
    peers, iinv = _peer_idx(tp)
    kidx = np.broadcast_to(np.arange(tp - 1), (tp, tp - 1))
    stmt_peers = stmt_s.take(peers, 1)                # [S, alice, tp-1]
    ek_alice_pairs = ek_s.expand(2)                   # [S, tp, 1]

    c_a = mta.paillier_encrypt_ints(ek_s, k, r_a, rn=rn_a)     # [S, tp]
    alice_proofs = alice_prove(
        k[:, :, None], c_a[:, :, None], ek_alice_pairs, stmt_peers,
        None if r_a_t is not None else r_a[:, :, None], rng,
        r_t=None if r_a_t is None else r_a_t[:, :, None])

    # MessageB (bob j responds to alice i) — both responder paths (gamma and
    # w) ride one stacked [2, ...] call
    pshape = (S, tp, tp - 1)
    c_a_pairs = np.broadcast_to(c_a[:, :, None], pshape)
    alice_ok = alice_verify_fast(alice_proofs, c_a_pairs, ek_alice_pairs, stmt_peers)
    b_stack = np.stack([gamma[:, peers], w[:, peers]])
    msg_b2, beta2, beta_rand2, beta_tag2, _ = mta.message_b(
        b_stack, ek_alice_pairs, c_a_pairs, None, None, rng)
    beta_g, beta_w = beta2[0], beta2[1]
    beta_tag = beta_tag2[0]
    msg_b_gamma = mta.msg_b_index(msg_b2, 0)
    msg_b_w = mta.msg_b_index(msg_b2, 1)

    dk_s = mta.expand_tree_axis(_dk_take(key.dk, s_parties, 1), 2)
    a_pairs = np.broadcast_to(k[:, :, None], pshape)
    alpha2, alpha_raw2, ok2 = mta.verify_proofs_get_alpha(
        dk_s, msg_b2, a_pairs[None], (2,) + pshape, ek_sk=ek_alice_pairs)
    alpha, miu = alpha2[0], alpha2[1]
    alpha_raw, miu_raw = alpha_raw2[0], alpha_raw2[1]
    ok_a, ok_m = ok2[0], ok2[1]
    # MtAwc check: bob's w commitment must match g_w_j
    gw_peers = dec.point_take(g_w, peers, 1)
    gwc = to_numpy(dec.point_eq(msg_b_w.b_proof.pk, gw_peers))
    mta_ok = (ok_a & ok_m & gwc)[:, iinv, kidx].all(axis=2)   # [S, bob]

    kg = np.mod(k * gamma, Q)
    kw = np.mod(k * w, Q)
    delta_i = np.mod(kg + np.sum(alpha, axis=2) + np.sum(beta_g[:, iinv, kidx], axis=2), Q)
    sigma_i = np.mod(kw + np.sum(miu, axis=2) + np.sum(beta_w[:, iinv, kidx], axis=2), Q)
    if step in (5, 6):
        for b, pi in _corrupt_slots(corrupt["parties"], S):
            _double_mod_q(delta_i if step == 5 else sigma_i, b, pi)

    # phase 3: T_i = sigma_i G + l_i H2 + Pedersen proof
    l_i = rng.scalars((S, tp))
    ped = sigma.pedersen_prove(sc(sigma_i), sc(l_i), rng)
    T_i = ped.T
    ped_ok = sigma.pedersen_verify(ped)

    # phase 3-4: delta reconstruction, decommit gamma, R
    delta = np.mod(np.sum(delta_i, axis=1), Q)
    delta_inv = np.asarray([pow(int(d), -1, Q) if int(d) else 0 for d in delta], dtype=object)
    com_ok = commit_rows(gg_dec_ints, blind1) == com1
    gg_peers = dec.point_take(g_gamma_dec, peers, 1)
    pk_ok = to_numpy(dec.point_eq(msg_b_gamma.b_proof.pk, gg_peers))[:, iinv, kidx].all(axis=2)
    gamma_sum = dec.point_sum(g_gamma_dec, axis=1)
    R = dec.scalar_mul(sc(delta_inv), gamma_sum)
    r_x = np.asarray(batch_from_limbs(dec.x_coord_mod_q(R)), dtype=object)

    # phase 5: R_bar = k_i R + PDLwSlack to each peer
    R_pairs = dec.point_expand(R, 1)
    R_bar = dec.scalar_mul(sc(k), R_pairs)           # [S, tp]
    pdl_stmt = PDLwSlackStatementBatch(
        ciphertext=np.broadcast_to(c_a[:, :, None], pshape),
        ek=ek_alice_pairs,
        Q_pt=dec.point_expand(R_bar, 2),
        G_pt=dec.point_expand(R_pairs, 2),
        dlog=stmt_peers,
    )
    pdl_proofs = pdl_slack_prove(
        np.broadcast_to(k[:, :, None], pshape),
        None if r_a_t is not None else np.broadcast_to(r_a[:, :, None], pshape),
        pdl_stmt, rng, r_t=None if r_a_t is None else r_a_t[:, :, None])
    pdl_ok = pdl_slack_verify_fast(pdl_proofs, pdl_stmt)  # [S, alice, tp-1]

    # phase5_check_R_dash_sum: sum R_bar == G
    rb_sum = dec.point_sum(R_bar, axis=1)
    rdash_ok = to_numpy(dec.point_eq(rb_sum, dec.generator((S,), dev)))

    # phase 6: S_i = sigma_i R + HomoElGamal consistency
    S_i = dec.scalar_mul(sc(sigma_i), R_pairs)
    H2, G = dec.base_point2((S, tp), dev), dec.generator((S, tp), dev)
    heg = sigma.homo_elgamal_prove(sc(l_i), sc(sigma_i), R_pairs, H2, G, T_i, S_i, rng)
    heg_ok = sigma.homo_elgamal_verify(heg, R_pairs, H2, G, T_i, S_i)
    s_sum = dec.point_sum(S_i, axis=1)
    s_sum_ok = to_numpy(dec.point_eq(s_sum, key.y))

    per_party_ok = (alice_ok.all(axis=2) & pdl_ok.all(axis=2) & mta_ok & pk_ok
                    & ped_ok & com_ok & heg_ok)  # [S, tp]
    ok = per_party_ok.all(axis=1) & rdash_ok & s_sum_ok
    debug_masks = {
        "alice": alice_ok, "pdl": pdl_ok, "mta": mta_ok, "pk": pk_ok,
        "ped": ped_ok, "com": com_ok, "heg": heg_ok,
        "rdash": rdash_ok, "s_sum": s_sum_ok,
    }
    dense = lambda a, fill: _unpack_dense(np.asarray(a, dtype=object), peers, fill)
    # the responder randomness is revealed only on blame: when the tables
    # deferred its launch it stays deferred (the gamma path is row 0)
    if hasattr(beta_rand2, "ints"):
        beta_rand_dense = LazyMap(
            beta_rand2, lambda v: _unpack_dense(np.asarray(v, dtype=object)[0], peers, 1))
    else:
        beta_rand_dense = dense(beta_rand2[0], 1)
    return OfflineState(
        s_parties=s_parties, R=R, r_x=r_x, k=k, sigma_i=sigma_i, delta_i=delta_i,
        y=key.y, ok=np.asarray(ok), bad_actors=~per_party_ok,
        k_randomness=r_a, gamma=gamma, beta_g=dense(beta_g, 0),
        beta_randomness=beta_rand_dense,
        beta_tag=dense(beta_tag, 0), alpha=dense(alpha_raw, 0), msg_a_c=c_a,
        msg_b_gamma_c=dense(msg_b_gamma.c, 0),
        R_bar=R_bar, S_i=S_i, T_i=T_i, l_i=l_i,
        m_b_w_c=dense(msg_b_w.c, 1), miu=dense(miu_raw, 0), ni=dense(beta_w, 0),
        debug_masks=debug_masks, g_gamma_decommit=g_gamma_dec,
    )


@dataclasses.dataclass
class SignResult20:
    r: np.ndarray
    s: np.ndarray
    recid: np.ndarray
    ok: np.ndarray
    sig_valid: np.ndarray
    s_i: np.ndarray = None  # [S, tp] partial sigs


def sign_online(off: OfflineState, m_int, corrupt: dict | None = None) -> SignResult20:
    """Phase 7: one-round online signing.  Every signature is checked by
    the batched ECDSA verifier (host/ec.py:ecdsa_verify_batch).
    corrupt={"step": 7, "parties": spec} doubles those parties' s_i."""
    S = off.k.shape[0]
    m_arr = np.broadcast_to(np.asarray(m_int, dtype=object), (S,))
    s_i = np.mod(np.mod(m_arr, Q)[:, None] * off.k + off.r_x[:, None] * off.sigma_i, Q)
    if corrupt and corrupt.get("step") == 7:
        for b, pi in _corrupt_slots(corrupt["parties"], S):
            _double_mod_q(s_i, b, pi)
    s_final, recid, sig_valid = _finish_signatures(off.R, np.mod(np.sum(s_i, axis=1), Q),
                                                   off.r_x, off.y, m_arr)
    ok = off.ok & sig_valid
    return SignResult20(r=off.r_x, s=s_final, recid=recid, ok=ok, sig_valid=sig_valid, s_i=s_i)
