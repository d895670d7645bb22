"""Port vs reference for the sharded model paths, against the JAX
package's own sharded functions: ``sharded_decode_attention``,
``decode_step`` under ``make_context(..., "decode")``, Kimi-K2's
``forward`` under ``moe_alltoall`` (dropless, and at capacity factor 1.25,
where the all-to-all is not the local MoE), and the serving engine's
``sharded_msa_fused`` / ``sharded_pool_ops``.

The reference runs in child processes with 8 forced CPU host devices
(``conftest.run_devices``: jax locks its device count at first init).
Its sharded functions call ``shard_map(..., check_rep=False)``, which
this jax (0.9) no longer accepts; each child therefore replaces the
module attribute ``shard_map`` of ``repro.distributed.flash_decode`` and
``repro.distributed.moe_ep`` with a wrapper that calls
``jax.shard_map(..., check_vma=False)`` (``_SHIM`` below).  Nothing in
``src/repro`` changes.  The port runs its shards in the same child, on
the CPU (``devices=["cpu"] * n``).  Each child prints one JSON line of
errors and counts; the tests assert on it.

Inputs and weights come from numpy seeds; weights cross through
``repro_torch.bridge.params_from_numpy``, wq/wk at fan-in as in
``tests/test_torch_models.py``.  Tolerances: 1e-5 for attention (abs,
the reference's ``test_flash_decode_matches_local``), 1e-5 relative for
decode logits (float32: the same algorithm summed in another order),
1e-4 relative for the MoE forward (the reference's
``test_moe_alltoall_matches_local``), page pools exactly."""
import json

import pytest

from conftest import run_devices

ATTN_TOL = 1e-5
DECODE_TOL = 1e-5
MOE_TOL = 1e-4

_SHIM = '''
import json
import numpy as np
import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(1)

import repro.distributed.flash_decode as _jfd
import repro.distributed.moe_ep as _jme


def _shard_map(f, **kw):
    # jax 0.9 dropped shard_map's check_rep (its successor: check_vma)
    kw.pop("check_rep", None)
    return jax.shard_map(f, check_vma=False, **kw)


_jfd.shard_map = _shard_map
_jme.shard_map = _shard_map

from repro.configs import get_smoke_config as j_smoke
from repro.configs import scaled_config as j_scaled
from repro.distributed.context import DistContext as JDist
from repro.distributed.context import use_dist as j_use
from repro.distributed.sharding import make_context as j_context
from repro.launch.mesh import make_mesh as j_mesh
from repro.models import model as jm
from repro_torch.bridge import params_from_numpy
from repro_torch.distributed import (DistContext, ShardedTensor,
                                     make_context, use_dist)
from repro_torch.launch.mesh import make_mesh


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        1e-30, float(np.max(np.abs(want))))


def models(cfg):
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    fan_in = float(np.sqrt(max(cfg.n_heads, 1) / cfg.d_model))
    for name in ("wq", "wk", "xwq", "xwk"):
        if name in jp["blocks"]:
            jp["blocks"][name] = (jp["blocks"][name] * fan_in).astype(
                jp["blocks"][name].dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
'''


def _child(body: str) -> dict:
    out = run_devices(_SHIM + body, 8)
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# sharded_decode_attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (mesh, rules, B, S, window, softcap)
    "reference": ((2, 4), {"batch": "data", "kv_seq": "model"}, 4, 32,
                  None, 0.0),
    "replicated_s30": ((2, 4), {"batch": "data", "kv_seq": "model"}, 4, 30,
                       None, 0.0),
    "window_softcap": ((2, 4), {"batch": "data", "kv_seq": "model"}, 4, 32,
                       5, 20.0),
    "batch1": ((2, 2), {"batch": None, "kv_seq": ("data", "model")}, 1, 32,
               None, 0.0),
    "batch1_window": ((2, 2), {"batch": None, "kv_seq": ("data", "model")},
                      1, 32, 7, 30.0),
}


@pytest.fixture(scope="module")
def attn_results():
    return _child(f"""
from repro.distributed.flash_decode import sharded_decode_attention as j_sda
from repro_torch.distributed import sharded_decode_attention
out = {{}}
for name, (shape, rules, B, S, window, softcap) in {ATTN_CASES!r}.items():
    rng = np.random.default_rng(len(name))
    H, KH, D = 4, 2, 16
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    kv_len = np.minimum(np.array([32, 17, 9, 1][:B], np.int32), S)
    jmesh = j_mesh(shape, ("data", "model"))
    with j_use(JDist(jmesh, rules, {{}})), jmesh:
        want = np.asarray(j_sda(*map(jnp.asarray, (q, k, v, kv_len)),
                                window=window, softcap=softcap))
    mesh = cpu_mesh(shape)
    with use_dist(DistContext(mesh, rules, {{}})):
        got = sharded_decode_attention(
            *map(torch.from_numpy, (q, k, v, kv_len)), window=window,
            softcap=softcap)
    out[name] = dict(err=float(np.max(np.abs(got.numpy() - want))),
                     ops=[list(k) + [v] for k, v in mesh.log.ops(0).items()])
print(json.dumps(out))
""")


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sharded_decode_attention_matches_jax(attn_results, case):
    """Each shard's partial at its global offset, merged exactly: the
    reference's sharded function on the same inputs, with one max and
    two sums over the ``kv_seq`` group."""
    shape, rules, *_ = ATTN_CASES[case]
    r = attn_results[case]
    assert r["err"] < ATTN_TOL, r
    n_seq = shape[1] if rules["kv_seq"] == "model" else shape[0] * shape[1]
    assert sorted(r["ops"]) == [["all-reduce", "max", n_seq, 1],
                                ["all-reduce", "sum", n_seq, 2]]


# ---------------------------------------------------------------------------
# decode_step under the decode context
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # name: (arch, mesh, B, overrides)
    "llama31-8b": ("llama31-8b", (2, 4), 4, {}),
    "llama31-8b_batch1": ("llama31-8b", (2, 2), 1, {}),
    "grok-1-314b": ("grok-1-314b", (2, 4), 4, {}),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", (2, 4), 4, {}),
    "gemma3-12b": ("gemma3-12b", (2, 4), 4, {}),
    "hymba-1.5b": ("hymba-1.5b", (2, 4), 4, {}),
    # 30 encoder frames over 4 shards: the cross-attention cache stays
    # whole on every shard (Whisper's 1500 frames)
    "whisper-large-v3": ("whisper-large-v3", (2, 4), 4, {"encoder_len": 30}),
    # 16 frames divide: the state holds them whole, and the attention cuts
    # them over the shards as the reference's shard_map in-specs do
    "whisper-large-v3_enc16": ("whisper-large-v3", (2, 4), 4, {}),
}
DECODE_STEPS = 4


@pytest.fixture(scope="module")
def decode_results():
    return _child(f"""
from repro_torch.models import decode_step, shard_decode_state
out = {{}}
for name, (arch, shape, B, over) in {DECODE_CASES!r}.items():
    cfg = j_scaled(j_smoke(arch), dtype="float32", **over)
    jp, tp = models(cfg)
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(np.asarray, jm.init_decode_state(cfg, B, 32))
    for key in ("k", "v", "conv", "ssm"):
        if key in jstate:
            jstate[key] = rng.standard_normal(jstate[key].shape).astype(
                jstate[key].dtype)
    jstate["pos"] = np.array([20, 13, 7, 2][:B], np.int32)
    if cfg.enc_dec:
        enc = rng.standard_normal((B, cfg.encoder_len, cfg.d_model)).astype(
            np.float32)
        jstate = jax.tree.map(np.asarray, jm.prep_cross_attention(
            jp, cfg, jnp.asarray(enc), jax.tree.map(jnp.asarray, jstate)))
    tstate = {{k: torch.from_numpy(v.copy()) for k, v in jstate.items()}}
    jstate = jax.tree.map(jnp.asarray, jstate)
    jmesh = j_mesh(shape, ("data", "model"))
    jctx = j_context(cfg, jmesh, "decode", batch_size=B)
    with j_use(jctx), jmesh:
        jstep = jax.jit(lambda p, s, t: jm.decode_step(p, cfg, s, t))
        mesh = cpu_mesh(shape)
        ctx = make_context(cfg, mesh, "decode", batch_size=B)
        tstate = shard_decode_state(tstate, ctx)
        errs, counts = [], None
        for step in range({DECODE_STEPS}):
            tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
            want, jstate = jstep(jp, jstate, jnp.asarray(tok))
            mesh.log.clear()
            with use_dist(ctx):
                got, tstate = decode_step(tp, cfg, tstate,
                                          torch.from_numpy(tok).long())
            counts = mesh.log.summary(0)
            errs.append(rel(got, want))
    caches = {{k: rel(v.full() if isinstance(v, ShardedTensor) else v,
                     jstate[k])
              for k, v in tstate.items() if k != "pos"}}
    out[name] = dict(errs=errs, caches=caches, rules=ctx.rules,
                     jrules=jctx.rules, flags=sorted(ctx.flags),
                     layers=cfg.n_layers,
                     counts={{k: v["count"] for k, v in counts.items()}})
print(json.dumps(out))
""")


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_step_under_context_matches_jax(decode_results, case):
    """Teacher-forced ``decode_step`` from the same random caches (rows at
    positions 20, 13, 7, 2: windows, contexts that cross shards), each
    step's logits and the final caches against the reference's
    ``decode_step`` under its own decode context; the collectives of a
    step on the first device."""
    arch, shape, B, _ = DECODE_CASES[case]
    r = decode_results[case]
    assert max(r["errs"]) < DECODE_TOL, r["errs"]
    assert max(r["caches"].values()) < DECODE_TOL, r["caches"]
    assert r["rules"] == r["jrules"]
    assert "flash_decode" in r["flags"]
    L = r["layers"]
    attn = 2 * L if arch == "whisper-large-v3" else L   # self + cross
    moe = arch in ("grok-1-314b", "kimi-k2-1t-a32b")
    want = {"all-reduce": 3 * attn + (L if moe else 0)}
    if moe:
        want["all-to-all"] = 2 * L
    assert r["counts"] == want


# ---------------------------------------------------------------------------
# the all-to-all MoE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_results():
    return _child("""
import dataclasses
from repro.models import forward as j_forward
from repro_torch.models import forward
rules = {"batch": "data", "experts": "data", "expert_ffn": "model"}
out = {}
toks = np.random.default_rng(1).integers(0, 256, (4, 16)).astype(np.int32)
for name, over in (("dropless", {}),
                   ("capacity_1.25", {"dropless": False,
                                      "capacity_factor": 1.25})):
    base = j_scaled(j_smoke("kimi-k2-1t-a32b"), dtype="float32")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            **over))
    jp, tp = models(cfg)
    jmesh = j_mesh((4, 2), ("data", "model"))
    local = np.asarray(j_forward(jp, cfg, {"tokens": jnp.asarray(toks)}))
    with j_use(JDist(jmesh, rules, {"moe_alltoall": True})), jmesh:
        want = np.asarray(j_forward(jp, cfg, {"tokens": jnp.asarray(toks)}))
    mesh = cpu_mesh((4, 2))
    with torch.no_grad(), use_dist(DistContext(mesh, rules,
                                               {"moe_alltoall": True})):
        got = forward(tp, cfg, {"tokens": torch.from_numpy(toks).long()})
    out[name] = dict(err=rel(got, want),
                     ref_vs_local=float(np.max(np.abs(want - local))),
                     ops=[list(k) + [v] for k, v in mesh.log.ops(0).items()],
                     layers=cfg.n_layers)
print(json.dumps(out))
""")


@pytest.mark.parametrize("case", ["dropless", "capacity_1.25"])
def test_moe_alltoall_matches_jax(moe_results, case):
    """Kimi-K2's smoke forward on the (data 4, model 2) mesh under
    ``moe_alltoall`` against the reference's all-to-all: dropless (where
    both are the local MoE) and at capacity factor 1.25, where capacity
    is counted per data shard and the reference itself differs from its
    local MoE; 2 all-to-alls over ``data`` and 1 sum over ``model`` a
    layer on the first device."""
    r = moe_results[case]
    assert r["err"] < MOE_TOL, r
    if case == "dropless":
        assert r["ref_vs_local"] < 1e-4
    else:
        assert r["ref_vs_local"] > 1e-2      # drops differ from local
    assert sorted(r["ops"]) == [["all-reduce", "sum", 2, r["layers"]],
                                ["all-to-all", "", 4, 2 * r["layers"]]]


# ---------------------------------------------------------------------------
# the serving engine's page-sharded attention and page ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_results():
    return _child("""
from jax.sharding import NamedSharding, PartitionSpec as JP
from repro.distributed.flash_decode import sharded_msa_fused as j_smf
from repro.distributed.flash_decode import sharded_pool_ops as j_spo
from repro.launch.mesh import make_serving_mesh as j_serving_mesh
from repro_torch.distributed import (ShardGroup, sharded_msa_fused,
                                     sharded_pool_ops)
out = {}
# the reference's test_sharded_attention_unit_equivalence case
rng = np.random.default_rng(0)
Pg, page, KH, D, H, T, N, NP = 16, 4, 2, 8, 4, 12, 5, 6
kp = rng.normal(size=(Pg, page, KH, D)).astype(np.float32)
vp = rng.normal(size=(Pg, page, KH, D)).astype(np.float32)
q = rng.normal(size=(T, H, D)).astype(np.float32)
kn = rng.normal(size=(T, KH, D)).astype(np.float32)
vn = rng.normal(size=(T, KH, D)).astype(np.float32)
bt = rng.integers(0, Pg, size=(N, NP)).astype(np.int32)
ctx = rng.integers(1, NP * page, size=(N,)).astype(np.int32)
sid = rng.integers(0, N, size=(T,)).astype(np.int32)
pos = np.minimum(rng.integers(0, NP * page, size=(T,)),
                 ctx[sid] - 1).astype(np.int32)
valid = rng.random(T) < 0.8
ws = rng.integers(0, Pg, size=(T,)).astype(np.int32)
wo = rng.integers(0, page, size=(T,)).astype(np.int32)
rest = (kn, vn, ws, wo, valid, bt, ctx, pos, sid)
for window, softcap in ((0, 0.0), (7, 5.0)):
    for n in (2, 4):
        jmesh = j_serving_mesh(n)
        sh = NamedSharding(jmesh, JP("model", None, None, None))
        kps, vps = jax.device_put(kp, sh), jax.device_put(vp, sh)
        jk, jv, jattn = jax.jit(lambda a, b: j_smf(
            jnp.asarray(q), a, b, *map(jnp.asarray, rest), mesh=jmesh,
            window=window, softcap=softcap))(kps, vps)
        p_loc = Pg // n
        drop = np.zeros((1, page, KH, D), np.float32)
        pools = [[torch.from_numpy(np.concatenate(
            [x[i * p_loc:(i + 1) * p_loc], drop])) for i in range(n)]
            for x in (kp, vp)]
        rep = lambda a: [torch.from_numpy(a)] * n
        attn = sharded_msa_fused(
            ShardGroup(["cpu"] * n), rep(q), pools[0], pools[1],
            *map(rep, rest), window=window, softcap=softcap)
        tk = torch.cat([p[:p_loc] for p in pools[0]]).numpy()
        tv = torch.cat([p[:p_loc] for p in pools[1]]).numpy()
        out[f"msa_fused n={n} window={window}"] = dict(
            err=max(float(np.max(np.abs(a.numpy() - np.asarray(jattn))))
                    for a in attn),
            pools=float(max(np.max(np.abs(tk - np.asarray(jk))),
                            np.max(np.abs(tv - np.asarray(jv))))))
# sharded_pool_ops: swap-ins then copy-on-write copies, shard-local
L, NB, page, S, C = 2, 32, 4, 3, 3
for n in (2, 4):
    rng = np.random.default_rng(n)
    p_loc = NB // n
    gk = rng.normal(size=(L, NB, page, KH, D)).astype(np.float32)
    gv = rng.normal(size=gk.shape).astype(np.float32)
    k_dst = np.full((n, S), p_loc, np.int32)
    v_dst = np.full((n, S), p_loc, np.int32)
    pay_k = rng.normal(size=(n, L, S, page, KH, D)).astype(np.float32)
    pay_v = rng.normal(size=pay_k.shape).astype(np.float32)
    c_src = np.zeros((n, C), np.int32)
    c_dst = np.zeros((n, C), np.int32)
    for i in range(n):
        slots = rng.permutation(p_loc)
        k_dst[i, :2] = slots[:2]
        v_dst[i, :1] = slots[2]
        c_src[i, :2], c_dst[i, :2] = slots[3:5], slots[5:7]
        c_src[i, 2:], c_dst[i, 2:] = c_src[i, 1], c_dst[i, 1]
    jmesh = j_serving_mesh(n)
    psh = NamedSharding(jmesh, JP(None, "model", None, None, None))
    ssh = NamedSharding(jmesh, JP("model", None, None, None, None, None))
    jk, jv = jax.jit(lambda a, b, c, d: j_spo(
        a, b, jnp.asarray(k_dst), jnp.asarray(v_dst), c, d,
        jnp.asarray(c_src), jnp.asarray(c_dst), mesh=jmesh))(
        jax.device_put(gk, psh), jax.device_put(gv, psh),
        jax.device_put(pay_k, ssh), jax.device_put(pay_v, ssh))
    drop = np.zeros((L, 1, page, KH, D), np.float32)
    shards = [[torch.from_numpy(np.concatenate(
        [g[:, i * p_loc:(i + 1) * p_loc], drop], axis=1))
        for i in range(n)] for g in (gk, gv)]
    sharded_pool_ops(ShardGroup(["cpu"] * n), shards[0], shards[1],
                     *(list(map(torch.from_numpy, a)) for a in (
                         k_dst, v_dst, pay_k, pay_v, c_src, c_dst)))
    tk = torch.cat([s[:, :p_loc] for s in shards[0]], dim=1).numpy()
    tv = torch.cat([s[:, :p_loc] for s in shards[1]], dim=1).numpy()
    out[f"pool_ops n={n}"] = dict(
        err=0.0, pools=float(max(np.max(np.abs(tk - np.asarray(jk))),
                                 np.max(np.abs(tv - np.asarray(jv))))),
        moved=float(np.max(np.abs(tk - gk))))
print(json.dumps(out))
""")


SERVING_CASES = [f"msa_fused n={n} window={w}" for w in (0, 7)
                 for n in (2, 4)] + ["pool_ops n=2", "pool_ops n=4"]


@pytest.mark.parametrize("case", SERVING_CASES)
def test_sharded_serving_matches_jax_sharded(serving_results, case):
    """The port's page-sharded attention and page ops against the
    reference's own ``sharded_msa_fused`` / ``sharded_pool_ops`` (the
    case of ``tests/test_sharded_serving.py``'s unit test): attention
    within 1e-5, the shards' pools the same bits."""
    r = serving_results[case]
    assert r["err"] < ATTN_TOL, r
    assert r["pools"] == 0.0, r
    if "moved" in r:
        assert r["moved"] > 0.0
