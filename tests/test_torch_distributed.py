"""Port vs reference for the mesh layer (``repro_torch.distributed``,
``repro_torch.launch.mesh`` against ``repro.distributed``,
``repro.launch.mesh``), in the main process: the shape-changing
adaptation (``effective_config``), the rules of every arch on every mesh
(through the reference's ``abstract_mesh``), the flags, the parameter,
optimizer-state, batch and decode-state shardings leaf by leaf, the
virtual expert split, and the port's own pieces (the all-to-all against
numpy, the collective log's ring factors, the mesh's groups, placing a
tensor over a mesh, the sequence-sharded decode and the all-to-all MoE
against the port's single-device functions).  The sharded functions are
held to the JAX package's own in ``tests/test_torch_mesh_parity.py``
(multi-device child processes).

Tolerances: 1e-5 at float32 (the reference's own bound for the virtual
split and the sharded decode: the same float32 algorithm, summed in
another order); the rules and shardings exactly.  One intra-op thread,
as ``test_torch_models.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.distributed.sharding as J
from repro.configs import get_config as j_config
from repro.launch.mesh import abstract_mesh as j_abstract_mesh
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config, \
    scaled_config
from repro_torch.distributed import (DistContext, ShardGroup,
                                     batch_shardings, decode_state_shardings,
                                     dist_flags, effective_config,
                                     make_context, moe_ffn_alltoall,
                                     opt_shardings, param_shardings, place,
                                     sharded_decode_attention, sharding_rules,
                                     use_dist)
from repro_torch.launch.mesh import (abstract_mesh, make_debug_mesh,
                                     make_mesh, make_production_mesh,
                                     make_serving_mesh)
from repro_torch.models import layers as tl
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, shard_decode_state)

ARCHS = ARCH_IDS + ("llama31-8b", "llama31-70b")
MESHES = (((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
KINDS = ("train", "prefill", "decode")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        1e-30, float(np.max(np.abs(want))))


def _cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _params(cfg, seed):
    """The port's random parameters with wq/wk at fan-in (at the
    reference's 1/sqrt(H) the Gemma smoke model's float32 logits carry
    ~1e-4 of rounding, ``tests/test_torch_models.py``)."""
    params = init_params(cfg, seed=seed, device="cpu")
    for name in ("wq", "wk"):
        params["blocks"][name] *= float(np.sqrt(cfg.n_heads / cfg.d_model))
    return params


def _flat_specs(tree):
    """{path: spec tuple} of a JAX tree of NamedShardings."""
    return {tuple(k.key for k in path): tuple(s.spec) for path, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree, prefix=()):
    """{path: spec tuple} of the port's nested dict of spec tuples."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# effective_config
# ---------------------------------------------------------------------------

def test_effective_config_reference_cases():
    """The reference's four cases (``tests/test_distributed.py``)."""
    cfg = effective_config(get_config("granite-3-8b"))
    assert cfg.vocab_size % 256 == 0 and cfg.real_vocab == 49155
    cfg = effective_config(get_config("llava-next-34b"))
    assert cfg.n_heads == 64 and cfg.n_kv_heads == 8
    cfg = effective_config(get_config("grok-1-314b"))
    assert cfg.moe.num_experts == 16 and cfg.moe.expert_split == 2
    assert cfg.d_ff == 16384
    full = get_config("grok-1-314b").param_count()
    assert abs(cfg.param_count() - full) < 0.01 * full
    cfg = effective_config(get_config("kimi-k2-1t-a32b"))
    assert cfg.moe.num_experts == 384 and cfg.moe.expert_split == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_effective_config_matches_jax(arch):
    for tp, ep in ((16, 16), (2, 2), (16, 32)):
        got = dataclasses.asdict(effective_config(get_config(arch), tp, ep))
        want = dataclasses.asdict(J.effective_config(j_config(arch), tp, ep))
        assert got == want, (arch, tp, ep)


def test_virtual_expert_split_exactness():
    """Column-split experts reproduce the unsplit MoE (the reference's
    case, from a numpy seed)."""
    rng = np.random.default_rng(0)
    t, d, e, f, k = 12, 16, 4, 32, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    rw = (rng.standard_normal((d, e)) * 0.1).astype(np.float32)
    we1, we3 = ((rng.standard_normal((e, d, f)) * 0.2).astype(np.float32)
                for _ in range(2))
    we2 = (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32)
    split, fs = 2, f // 2

    def sp(w):
        return w.reshape(e, d, split, fs).transpose(0, 2, 1, 3).reshape(
            e * split, d, fs)

    we2s = we2.reshape(e * split, fs, d)
    T = torch.from_numpy
    base = tl.moe_ffn_local(T(x), T(rw), T(we1), T(we3), T(we2), k,
                            dropless=True)
    out = tl.moe_ffn_local(T(x), T(rw), T(sp(we1)), T(sp(we3)), T(we2s), k,
                           dropless=True, expert_split=split)
    np.testing.assert_allclose(out.numpy(), base.numpy(), atol=TOL,
                               rtol=TOL)
    want = jl.moe_ffn_local(x, rw, sp(we1), sp(we3), we2s, k, dropless=True,
                            expert_split=split)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# rules, flags, shardings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_match_jax(arch):
    for shape, axes in MESHES:
        mesh, jmesh = abstract_mesh(shape, axes), j_abstract_mesh(shape,
                                                                  axes)
        cfg = effective_config(get_config(arch), shape[-1], shape[-2])
        jcfg = J.effective_config(j_config(arch), shape[-1], shape[-2])
        for kind in KINDS:
            for bs in (0, 1, 8):
                got = sharding_rules(cfg, mesh, kind, batch_size=bs)
                assert got == J.sharding_rules(jcfg, jmesh, kind,
                                               batch_size=bs), \
                    (arch, shape, kind, bs)
                if kind == "decode" and bs == 1 and cfg.family != "ssm":
                    assert got["batch"] is None
                    assert got["kv_seq"] == axes


def test_sharding_rules_of_n_are_the_serving_mesh():
    """The port's ``sharding_rules(cfg, n, kind)`` (the serving engine's
    form) is the ``(1, n)`` mesh's."""
    for arch in ("llama31-8b", "grok-1-314b", "mamba2-780m"):
        cfg = get_smoke_config(arch)
        for n in (1, 2, 4):
            for kind in KINDS:
                assert sharding_rules(cfg, n, kind) == sharding_rules(
                    cfg, abstract_mesh((1, n), ("data", "model")), kind)


@pytest.mark.parametrize("env", [{}, {"REPRO_AR_BARRIER": "1",
                                      "REPRO_SEQ_PARALLEL": "1"}])
def test_dist_flags_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for arch in ARCHS:
        for kind in KINDS:
            got = dist_flags(get_config(arch), kind)
            assert got == J.dist_flags(j_config(arch), kind), (arch, kind)
            assert ("seq_parallel" in got) == (bool(env)
                                               and kind != "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_jax_leaf_by_leaf(arch):
    """Parameter, AdamW and Adafactor state, batch and decode-state
    shardings: the same mesh axes per dim on every leaf."""
    for shape, axes in MESHES[:2]:
        mesh, jmesh = abstract_mesh(shape, axes), j_abstract_mesh(shape,
                                                                  axes)
        cfg = effective_config(get_config(arch), shape[-1], shape[-2])
        jcfg = J.effective_config(j_config(arch), shape[-1], shape[-2])
        for kind, bs in (("train", 8), ("decode", 8), ("decode", 1)):
            rules = sharding_rules(cfg, mesh, kind, batch_size=bs)
            jrules = J.sharding_rules(jcfg, jmesh, kind, batch_size=bs)
            assert _flat(param_shardings(cfg, mesh, rules)) == _flat_specs(
                J.param_shardings(jcfg, jmesh, jrules))
            for opt in ("adamw", "adafactor"):
                assert _flat(opt_shardings(opt, cfg, mesh, rules)) == \
                    _flat_specs(J.opt_shardings(opt, jcfg, jmesh, jrules))
            batch = {"tokens": np.zeros((bs, 16), np.int32),
                     "labels": np.zeros((bs, 16), np.int32),
                     "enc_embeds": np.zeros((bs, 4, 8), np.float32)}
            assert _flat(batch_shardings(cfg, mesh, rules, batch)) == \
                _flat_specs(J.batch_shardings(jcfg, jmesh, jrules, batch))
            smoke = get_smoke_config(arch)
            if smoke.family != "ssm" and smoke.sliding_window > 0 \
                    and smoke.local_global_ratio <= 0:
                continue                 # pure sliding-window: refused
            state = init_decode_state(smoke, bs, 16, device="cpu")
            jstate = jm.init_decode_state(smoke, bs, 16, abstract=True)
            assert _flat(decode_state_shardings(cfg, mesh, rules,
                                                state)) == \
                _flat_specs(J.decode_state_shardings(jcfg, jmesh, jrules,
                                                     jstate))
    with pytest.raises(ValueError):
        opt_shardings("sgd", get_config(arch), abstract_mesh((2, 2), (
            "data", "model")), {})


# ---------------------------------------------------------------------------
# the mesh, its groups, collectives and log
# ---------------------------------------------------------------------------

def test_mesh_builders():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.devices is None
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512
    with pytest.raises(ValueError):
        m.device(0)                                   # shapes only
    assert make_debug_mesh(devices=["cpu"]).shape == {"data": 1, "model": 1}
    s = make_serving_mesh(3, devices=["cpu"] * 3)
    assert s.shape == {"data": 1, "model": 3}
    g = s.group("model")
    assert g.n == 3 and g.ranks == (0, 1, 2) and g.log is s.log
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises((ValueError, RuntimeError)):
            make_mesh((1, 2), ("data", "model"))      # never picks the CPU


def test_mesh_groups_follow_axis_order():
    """``mesh.group(axes, at)``: row-major over the axes given, the other
    axes fixed at ``at`` (the shard order of ``jax.lax.axis_index``)."""
    m = _cpu_mesh((2, 2, 3), ("pod", "data", "model"))
    assert m.coords(7) == {"pod": 1, "data": 0, "model": 1}
    assert m.rank(m.coords(7)) == 7
    assert m.group("model", at=7).ranks == (6, 7, 8)
    assert m.group("data", at=7).ranks == (7, 10)
    assert m.group(("data", "model"), at={"pod": 1}).ranks == tuple(
        range(6, 12))
    assert m.group(("pod", "data"), at={"model": 2}).ranks == (2, 5, 8, 11)
    for r in range(m.size):
        i = m.index(r, ("pod", "model"))
        assert m.position(("pod", "model"), i) == {
            a: m.coords(r)[a] for a in ("pod", "model")}


@pytest.mark.parametrize("n,split_dim,concat_dim", [(2, 0, 1), (4, 0, 1),
                                                    (4, 1, 0), (3, 2, 0)])
def test_all_to_all_matches_numpy(n, split_dim, concat_dim):
    """Tiled all-to-all: shard j gets block j of every shard's tensor,
    concatenated in shard order."""
    rng = np.random.default_rng(n)
    shape = [12, 12, 12]
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    g = ShardGroup(["cpu"] * n)
    out = g.all_to_all([torch.from_numpy(x) for x in xs], split_dim,
                       concat_dim)
    for j in range(n):
        want = np.concatenate([np.split(x, n, axis=split_dim)[j]
                               for x in xs], axis=concat_dim)
        np.testing.assert_array_equal(out[j].numpy(), want)
    with pytest.raises(ValueError):
        g.all_to_all([torch.zeros(5, 2)] * n, 0, 1)


def test_collective_log_ring_factors():
    """The log's summary has ``parse_collectives``' shape and factors,
    counted for the device at the given rank."""
    m = _cpu_mesh((2, 4))
    x = torch.zeros(8, 4)                                  # 128 bytes
    g = m.group("model", at=0)
    g.all_reduce_sum([x] * 4)
    g.all_reduce_max([x] * 4)
    m.group("data", at=1).all_to_all([x] * 2, 0, 1)
    m.group("data", at=0).all_gather([x] * 2, 0)
    m.group("model", at=4).all_reduce_sum([x] * 4)          # not rank 0's
    s = m.log.summary(0)
    assert s["all-reduce"] == {"count": 2, "wire_bytes": 2 * 2 * 128 * 3 / 4}
    assert s["all-gather"] == {"count": 1, "wire_bytes": 256 * 1 / 2}
    assert "all-to-all" not in s
    assert m.log.summary(1)["all-to-all"] == {"count": 1,
                                              "wire_bytes": 128 / 2}
    ShardGroup(["cpu"], log=m.log).all_reduce_sum([x])      # moves nothing
    g.all_reduce_sum([x] * 4)                               # counted again
    assert sum(m.log.counts.values()) == 6
    assert m.log.ops(0) == {("all-reduce", "sum", 4): 2,
                            ("all-reduce", "max", 4): 1,
                            ("all-gather", "", 2): 1}
    m.log.clear()
    assert m.log.summary() == {}


def test_place_cuts_views_and_reassembles():
    m = _cpu_mesh((2, 3))
    x = torch.arange(4 * 6 * 5, dtype=torch.float32).view(4, 6, 5).clone()
    st = place(x, ("data", "model", None), m)
    assert st.spec == ("data", "model", None)
    assert all(p.shape == (2, 2, 5) for p in st.pieces)
    assert all(p._base is x for p in st.pieces)
    assert torch.equal(st.full(), x)
    # a dim that does not divide stays whole (the decode cache's rule)
    st = place(x[:, :5], (None, ("data", "model"), None), m)
    assert st.spec == (None, None, None)
    assert torch.equal(st.pieces[4], x[:, :5])
    assert torch.equal(place(x, (None, ("data", "model"), None), m).select(
        1).full(), x[1])


# ---------------------------------------------------------------------------
# the sharded paths against the port's single-device functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rules,B", [
    ((2, 4), {"batch": "data", "kv_seq": "model"}, 4),
    ((2, 2), {"batch": None, "kv_seq": ("data", "model")}, 1),
    ((1, 4), {"batch": "data", "kv_seq": "model"}, 3)])
@pytest.mark.parametrize("S,window,softcap", [(32, None, 0.0),
                                              (30, None, 0.0),
                                              (32, 5, 20.0)])
def test_sharded_decode_attention_matches_decode_attention(shape, rules, B,
                                                           S, window,
                                                           softcap):
    """Each shard's partial at its global offset, merged exactly: the
    single-device decode attention (and one max and two sums a batch
    group, none for a whole cache on every shard)."""
    rng = np.random.default_rng(S + B)
    H, KH, D = 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(
        np.float32)) for _ in range(2))
    kv_len = torch.tensor([S, 17, 9, 1][:B], dtype=torch.int32)
    want = tl.decode_attention(q, k, v, kv_len, window=window,
                               softcap=softcap)
    mesh = _cpu_mesh(shape)
    with use_dist(DistContext(mesh, rules, {})):
        got = sharded_decode_attention(q, k, v, kv_len, window=window,
                                       softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    s = mesh.log.summary(0)
    n = mesh.size_of(rules["kv_seq"])
    assert mesh.log.ops(0) == {("all-reduce", "max", n): 1,
                               ("all-reduce", "sum", n): 2}


@pytest.mark.parametrize("arch,shape,B", [("llama31-8b", (2, 2), 4),
                                          ("llama31-8b", (2, 2), 1),
                                          ("gemma3-12b", (1, 4), 2),
                                          ("grok-1-314b", (2, 2), 2)])
def test_sharded_decode_step_matches_unsharded(arch, shape, B):
    """``decode_step`` under ``make_context(..., "decode")`` on a state
    placed by ``shard_decode_state`` against the unsharded step on a copy:
    the same logits each step, the caches written where they belong (the
    first layer's K/V the same bits, later layers' within the tolerance
    their inputs carry)."""
    cfg = scaled_config(get_smoke_config(arch), dtype="float32")
    params = _params(cfg, seed=1)
    rng = np.random.default_rng(0)
    state = init_decode_state(cfg, B, 32, device="cpu")
    for seed, key in enumerate(("k", "v")):
        state[key].normal_(generator=torch.Generator().manual_seed(seed))
    state["pos"] = torch.tensor([20, 13, 7, 2][:B], dtype=torch.int32)
    plain = {k: v.clone() for k, v in state.items()}
    mesh = _cpu_mesh(shape)
    ctx = make_context(cfg, mesh, "decode", batch_size=B)
    sharded = shard_decode_state(state, ctx)
    for step in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B))
        want, plain = decode_step(params, cfg, plain, tok)
        with use_dist(ctx):
            got, sharded = decode_step(params, cfg, sharded, tok)
        assert _rel(got, want.numpy()) < TOL, (arch, step)
    for key in ("k", "v"):
        got = sharded[key].full()
        assert torch.equal(got[0], plain[key][0])
        assert _rel(got, plain[key].numpy()) < TOL
    assert torch.equal(sharded["k"].full(), state["k"])    # views


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (1, 2)])
def test_moe_alltoall_dropless_matches_local(shape):
    """Dropless, the all-to-all MoE is the local one (every slot fits,
    in both): Kimi's smoke forward, and 2 all-to-alls and 1 sum a layer
    on the first device."""
    cfg = scaled_config(get_smoke_config("kimi-k2-1t-a32b"),
                        dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)))
    with torch.no_grad():
        want = forward(params, cfg, {"tokens": toks})
        mesh = _cpu_mesh(shape)
        with use_dist(make_context(cfg, mesh, "train", batch_size=4)):
            got = forward(params, cfg, {"tokens": toks})
    assert _rel(got, want.numpy()) < 1e-4
    want = {}
    if shape[0] > 1:
        want["all-to-all", "", shape[0]] = 2 * cfg.n_layers
    if shape[1] > 1:
        want["all-reduce", "sum", shape[1]] = cfg.n_layers
    assert mesh.log.ops(0) == want


def test_moe_alltoall_expert_weights_are_views():
    """Shards on one device cut the expert stacks as views."""
    cfg = scaled_config(get_smoke_config("kimi-k2-1t-a32b"),
                        dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    blk = {k: v[0] for k, v in params["blocks"].items()}
    seen = []
    real_bmm = torch.bmm

    def spy(a, b, **kw):
        seen.append(b)
        return real_bmm(a, b, **kw)

    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    with use_dist(make_context(cfg, _cpu_mesh((2, 2)), "train")):
        torch.bmm = spy
        try:
            moe_ffn_alltoall(x, blk["router"], blk["we1"], blk["we3"],
                             blk["we2"], cfg)
        finally:
            torch.bmm = real_bmm
    stacks = {params["blocks"][k].untyped_storage().data_ptr()
              for k in ("we1", "we3", "we2")}
    weights = [w for w in seen
               if w.untyped_storage().data_ptr() in stacks]
    assert len(weights) == 3 * 4 and all(w._base is not None
                                         for w in weights)
