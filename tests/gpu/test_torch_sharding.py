"""Sessions-axis sharding of the port (tpu_mpc_torch/sharding/) on the CPU.

A mesh of repeated CPU entries (["cpu"] * 8), the counterpart of the JAX
package's 8 virtual CPU devices (tests/test_sharding.py), splits every
K1-K5 launch into pieces that run the plain versions in turn, and the
gather puts their outputs back in order.  Four `gloo` processes hold the
mesh over ranks.  Every output is an integer: tolerance 0.

- modexp and EC under the mesh against python pow and host/ec.py;
- the partition rule against the JAX package's own shard_flat, live (a
  device_put, no compilation);
- GG20 offline_stage + sign_online, tables configuration, under a
  2-entry mesh against the golden of the JAX package's run
  (tests/gpu/fixtures/gg20_slice_768.json, the key, seed and message of
  test_torch_gg20.py), with every plain kernel's lane counts recorded to
  show that K1-K5 ran in pieces;
- four ranks: every rank's modexp and EC equal python's, and inputs that
  differ on one rank make every rank raise;
- operands on a card never run a piece on a CPU entry or over a gloo group.
"""

import hashlib
import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
FIXTURE = os.path.join(HERE, "..", "fixtures", "gg20key_20_2_1_3_768.json")
GOLD = os.path.join(HERE, "fixtures", "gg20_slice_768.json")
SEED = 0x5169
S = 2
RANKS = 4
RANK_TIMEOUT = 120      # seconds for the four processes together


def _mesh(n):
    from tpu_mpc_torch import sharding

    return sharding.sessions_mesh(devices=["cpu"] * n)


def _modexp_case(S_, seed=3):
    r = np.random.RandomState(seed)
    mods = np.asarray([(1 << 255) + 2 * int(r.randint(1 << 30)) + 1 for _ in range(S_)],
                      dtype=object)
    base = np.asarray([int(r.randint(1 << 30)) ** 3 + 7 for _ in range(S_)], dtype=object)
    expo = np.asarray([int(r.randint(1 << 30)) + 3 for _ in range(S_)], dtype=object)
    return mods, base, expo


@pytest.mark.parametrize("reduce", [False, True], ids=["pow", "pow_prod_axis0"])
def test_modexp_sharded_matches_host(monkeypatch, reduce):
    """256-bit modexp, S = 16, over an 8-entry CPU mesh: 8 pieces of 2
    lanes, equal to python pow.  ModCtx.pow has a modulus row a lane;
    pow_prod_axis0 shares one row and takes the product over the sessions
    after the gather, on the caller's device."""
    from tpu_mpc_torch import sharding
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.modctx import ModCtx

    seen = []
    real = pr.exp_plain
    monkeypatch.setattr(pr, "exp_plain", lambda *a, **kw: seen.append(a[0].shape[0])
                        or real(*a, **kw))
    mods, base, expo = _modexp_case(16)
    if reduce:
        mods = np.asarray([mods[0]] * 16, dtype=object)
    with sharding.use_mesh(_mesh(8)):
        ctx = ModCtx.from_ints(mods, 256, "cpu")
        got = ctx.pow_prod_axis0(base, expo, 31) if reduce else ctx.pow(base, expo)
    assert seen == [2] * 8
    want = [pow(int(b), int(e), int(m)) for b, e, m in zip(base, expo, mods)]
    if reduce:
        prod = 1
        for w in want:
            prod = prod * w % int(mods[0])
        want = [prod]
    assert [int(g) for g in got] == want


def test_partition_rule_equals_reference():
    """For B in (1, 6, 8, 16, 24, 128) under 8 entries, the port's shard_flat
    gives as many pieces as the JAX package's shard_flat puts the operand on
    devices; the pieces are contiguous row blocks in order.  shard_leading
    follows the same rule on the sessions axis."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_mpc import sharding as ref
    from tpu_mpc_torch import sharding

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    jmesh, tmesh = ref.sessions_mesh(8), _mesh(8)
    for B in (1, 6, 8, 16, 24, 128):
        with ref.use_mesh(jmesh):
            want = len(ref.shard_flat(jnp.zeros((B, 4), jnp.uint32)).sharding.device_set)
            want_lead = len(ref.shard_leading(jnp.zeros((B, 3, 4), jnp.uint32),
                                              (B, 3)).sharding.device_set)
        x = torch.arange(B * 4).reshape(B, 4)
        with sharding.use_mesh(tmesh):
            pieces = sharding.shard_flat(x)
            lead = sharding.shard_leading(x.reshape(B, 1, 4).expand(B, 3, 4), (B, 3))
        assert len(pieces) == want, B
        assert len(lead) == want_lead, B
        assert torch.equal(torch.cat(pieces), x)
        assert len({p.shape[0] for p in pieces}) == 1
    (one,) = sharding.shard_flat(x)                 # no mesh: one piece, unchanged
    assert one is x


def test_ec_mul_generator_to_affine_sharded():
    """mul_generator (K4) + to_affine (K5) at 16 lanes over 4 entries, equal
    to the host oracle."""
    from tpu_mpc_torch import sharding
    from tpu_mpc_torch.core.limbs import batch_from_limbs
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    ks = np.asarray([(i * 0x9E3779B97F4A7C15 + 1) % hec.N for i in range(1, 17)], dtype=object)
    with sharding.use_mesh(_mesh(4)):
        x, y, inf = ec.to_affine(ec.mul_generator(ec.sc_from_ints(ks, "cpu")))
    xs, ys = batch_from_limbs(x.numpy()), batch_from_limbs(y.numpy())
    assert not inf.any()
    assert [(int(a), int(b)) for a, b in zip(xs, ys)] == [hec.mul(int(k)) for k in ks]


def _key_dict():
    with open(FIXTURE) as f:
        d = json.load(f)
    d1 = {k: ([v[0]] * S if isinstance(v, list) else v) for k, v in d.items()}
    d1["S"] = S
    return d1


def test_gg20_sharded_equals_reference_golden():
    """GG20 2-of-3 offline_stage + sign_online, tables configuration, under
    a 2-entry CPU mesh on the golden run's key (S = 2), seed and message:
    (r, s, recid) and the offline transcript equal the JAX package's, field
    for field.  Every wrapper call of K1-K5 with an even lane count ran as
    two pieces of half its lanes, each through the plain version, and each
    kernel had such a call.  The tables configuration is the one that
    reaches all five kernels; the uniform one's kernels are K1, K3, K4 and
    K5 on the same wrappers, and a mesh doubles the plain versions' calls,
    so it is left to test_torch_gg20.py unsharded, within the file's
    time."""
    from tpu_mpc_torch import sharding
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    with open(GOLD) as f:
        gold = json.load(f)
    ref = gold["tables"]
    m = int.from_bytes(hashlib.sha256(b"gg20 message").digest(), "big")
    assert m == int(gold["m"]) and (gold["seed"], gold["S"]) == (SEED, S)
    names = {"K1": (pr, "exp_call", "exp_plain"), "K2": (pr, "fixed_call", "fixed_plain"),
             "K3": (pe, "ladder_call", "ladder_plain"), "K4": (pe, "comb_call", "comb_plain"),
             "K5": (pe, "affine_call", "affine_plain")}
    calls = {k: [] for k in names}
    pieces = {k: [] for k in names}

    def rec(log, fn):
        return lambda *a, **kw: log.append(a[0].shape[0]) or fn(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_BATCH_VERIFY", "1")
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
        key = tg.key_from_material(_key_dict(), device="cpu")
        for k, (mod, call, plain) in names.items():
            mp.setattr(mod, call, rec(calls[k], getattr(mod, call)))
            mp.setattr(mod, plain, rec(pieces[k], getattr(mod, plain)))
        with sharding.use_mesh(_mesh(2)):
            off = tg.offline_stage(key, [0, 1], SessionRng(SEED))
            sig = tg.sign_online(off, m)
    assert [int(v) for v in sig.r] == [int(v) for v in ref["r"]]
    assert [int(v) for v in sig.s] == [int(v) for v in ref["s"]]
    assert [int(v) for v in sig.recid] == [int(v) for v in ref["recid"]]
    assert sig.sig_valid.all() and sig.ok.all() and off.ok.all()
    for f in ("r_x", "k", "sigma_i", "delta_i", "msg_a_c", "alpha", "beta_g", "miu"):
        want = np.vectorize(int, otypes=[object])(np.asarray(ref[f], dtype=object))
        assert np.array_equal(np.asarray(getattr(off, f), dtype=object), want), f
    for k in names:
        split = [B for B in calls[k] if B and B % 2 == 0]
        assert split, k
        assert sorted(pieces[k]) == sorted(
            [B // 2 for B in split for _ in range(2)]
            + [B for B in calls[k] if not B or B % 2]), k


_RANK_PROGRAM = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from tpu_mpc_torch import sharding
from tpu_mpc_torch.core import pallas_rns as pr
from tpu_mpc_torch.core.limbs import batch_from_limbs
from tpu_mpc_torch.core.modctx import ModCtx
from tpu_mpc_torch.ec import secp256k1 as ec
from tpu_mpc_torch.host import ec as hec
from tpu_mpc_torch.zk.batch_verify import sample_gammas

assert sharding.maybe_init_distributed()
mesh = sharding.sessions_mesh()
seen = []
real = pr.exp_plain
pr.exp_plain = lambda *a, **kw: seen.append(a[0].shape[0]) or real(*a, **kw)
r = np.random.RandomState(3)
S = 16
mods = [(1 << 255) + 2 * int(r.randint(1 << 30)) + 1 for _ in range(S)]
base = [int(r.randint(1 << 30)) ** 3 + 7 for _ in range(S)]
expo = [int(r.randint(1 << 30)) + 3 for _ in range(S)]
ks = [(i * 0x9E3779B97F4A7C15 + 1) % hec.N for i in range(1, S + 1)]
out = {"rank": mesh.rank, "size": mesh.size}
with sharding.use_mesh(mesh):
    ctx = ModCtx.from_ints(np.asarray(mods, dtype=object), 256, "cpu")
    got = ctx.pow(np.asarray(base, dtype=object), np.asarray(expo, dtype=object))
    out["pow"] = [int(g) for g in got] == [pow(b, e, m) for b, e, m in zip(base, expo, mods)]
    out["k1_pieces"] = seen
    x, y, inf = ec.to_affine(ec.mul_generator(ec.sc_from_ints(np.asarray(ks, dtype=object), "cpu")))
    xs, ys = batch_from_limbs(x.numpy()), batch_from_limbs(y.numpy())
    out["ec"] = [(int(a), int(b)) for a, b in zip(xs, ys)] == [hec.mul(k) for k in ks]
    out["gammas"] = [str(g) for g in sample_gammas((4,))]
    bad = list(base)
    if mesh.rank == 2:
        bad[5] += 1
    try:
        ctx.pow(np.asarray(bad, dtype=object), np.asarray(expo, dtype=object))
        out["mismatch"] = "no error"
    except RuntimeError as exc:
        out["mismatch"] = "raised" if "different inputs" in str(exc) else str(exc)
print("RESULT " + json.dumps(out), flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_gloo_ranks_agree_and_refuse_mismatched_inputs():
    """Four processes, one rank each, the gloo backend: under sessions_mesh()
    (a mesh over the ranks) each rank runs a quarter of the K1 lanes and
    every rank's ModCtx.pow and mul_generator + to_affine equal python pow
    and the host EC, and the batch verifier's gammas are rank 0's on every
    rank; then rank 2 alone changes one base, and every rank raises within
    the timeout (the processes are killed after it)."""
    env = dict(os.environ, PYTHONPATH=REPO, TPU_MPC_TORCH_DISTRIBUTED="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(RANKS), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_PROGRAM], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
        line = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
        assert line, so + se[-3000:]
        results.append(json.loads(line[0][len("RESULT "):]))
    assert sorted(r["rank"] for r in results) == list(range(RANKS))
    gammas = [r.pop("gammas") for r in results]
    assert len(set(gammas[0])) == 4 and all(g == gammas[0] for g in gammas)
    for r in results:
        assert r == {"rank": r["rank"], "size": RANKS, "pow": True,
                     "k1_pieces": [16 // RANKS], "ec": True, "mismatch": "raised"}, r


def test_a_mesh_never_runs_card_operands_on_the_cpu(monkeypatch):
    """Operands on a card under a mesh with a CPU entry raise before any
    piece launches (the CPU piece would take the plain version, and the
    gather would hide it); so does a mesh over the ranks of a gloo group on
    a machine with a card.  No card is needed: a stand-in operand carries
    the card's device, and the group is a stand-in too."""
    from types import SimpleNamespace

    from tpu_mpc_torch import sharding
    from tpu_mpc_torch.sharding import mesh as shm

    card = torch.device("cuda", 0)
    ran = []
    fake = SimpleNamespace(shape=(8, 4), device=card)
    for devices in ([torch.device("cpu")] * 2, [card, torch.device("cpu")]):
        with sharding.use_mesh(shm.Mesh(devices)):
            with pytest.raises(RuntimeError, match="plain version"):
                shm.launch(lambda *a: ran.append(a), (fake,), (0,))
    assert not ran
    shm._check_entries(shm.Mesh([card] * 2), card)            # card entries: fine
    shm._check_entries(shm.Mesh([torch.device("cpu")] * 2), torch.device("cpu"))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="gloo process group on a machine with a card"):
        sharding.sessions_mesh()


def test_distributed_off_by_default(monkeypatch):
    """Without TPU_MPC_TORCH_DISTRIBUTED=1 nothing is initialised; without a
    card, sessions_mesh() over the visible cards raises rather than run on
    the CPU."""
    from tpu_mpc_torch import sharding

    monkeypatch.delenv("TPU_MPC_TORCH_DISTRIBUTED", raising=False)
    assert sharding.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert sharding.current_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sharding.sessions_mesh()
    rnd = random.Random(1)
    x = torch.as_tensor([[rnd.randrange(1 << 16) for _ in range(4)] for _ in range(6)])
    with sharding.use_mesh(_mesh(4)):
        (one,) = sharding.shard_flat(x)             # 6 lanes do not divide by 4
        assert one is x
        assert len(sharding.shard_flat(x[:4])) == 4
    assert sharding.current_mesh() is None
