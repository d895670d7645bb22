"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

The reference's side runs in ONE child process with 8 forced host
devices (``conftest.run_devices``; importing ``repro.launch.dryrun``
sets the device count): its ``--list`` grid, ``grad_accum_for`` and
``input_specs`` on every arch x shape, ``_combine``, the per-device
``argument_size_in_bytes`` of ``chatglm3-6b`` ``train_4k`` at seq 64 x
batch 8 on the (4, 2) mesh (as ``tests/test_distributed.py`` shrinks
it), the collectives of that cell, its prefill and whisper-large-v3's
train cell (``parse_collectives`` of the probes), and ``cost_analysis``
FLOPs of prefill probes of Llama-3.1-8B's full width (1 and 2 layers,
seq 512, on a (1, 1) mesh).

Held to: the same grid, accumulation, shapes and dtypes; argument bytes
exactly; the all-reduces' wire bytes within 1e-6; the probes' FLOPs
within 2% (``FlopCounterMode`` counts the GEMM-class ops, XLA every op:
measured 0.7% apart).  Then the port's
own identities on the CPU: the dry run's FLOPs at (1, 1) equal
``FlopCounterMode``'s count of the real train and decode steps (the
same ops), and the logged collectives of a sharded decode equal the
mesh's ``CollectiveLog`` of the real sharded step.  One intra-op
thread."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from conftest import run_devices
from repro_torch.configs import (ARCH_IDS, SHAPE_BY_NAME, SHAPES, get_config,
                                 get_smoke_config, scaled_config)
from repro_torch.distributed import make_context, use_dist
from repro_torch.distributed.sharding import effective_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh, make_mesh
from repro_torch.models import decode_step, init_decode_state, init_params
from repro_torch.models import shard_decode_state
from repro_torch.training import adamw
from repro_torch.training.train_step import make_train_step

PROBE_FLOP_TOL = 0.02
# the reckoned all-reduces against XLA's: the loss's few bytes a token
# that XLA packs apart (a (b, s, 1) operand) are not reckoned
COLLECTIVE_TOL = 1e-6
# dense cells on the (4, 2) mesh at seq 64 x batch 8: untied (chatglm3)
# and tied embeddings with an encoder and cross-attention (whisper)
COLLECTIVE_CELLS = [("chatglm3-6b", "train_4k"),
                    ("chatglm3-6b", "prefill_32k"),
                    ("whisper-large-v3", "train_4k")]

_CHILD = """
import contextlib, dataclasses, io, json, sys, tempfile
import jax
import repro.launch.mesh as mesh_mod
import repro.launch.dryrun as dr
import repro.configs.base as cb
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.distributed.context import DistContext
from repro.distributed.sharding import effective_config, make_context

out = {}
buf = io.StringIO()
sys.argv = ["dryrun", "--list"]
with contextlib.redirect_stdout(buf):
    dr.main()
out["list"] = buf.getvalue()
out["accum"], out["specs"] = {}, {}
for a in ARCH_IDS:
    cfg = effective_config(get_config(a), tp=16, ep=16)
    for s in SHAPES:
        out["accum"][a + "/" + s.name] = dr.grad_accum_for(cfg, s, 16)
        sp = dr.input_specs(cfg, s.kind, 4, 64)
        flat = dict(sp.get("state", {}), **{k: v for k, v in sp.items()
                                            if k != "state"})
        out["specs"][a + "/" + s.name] = {
            k: [list(v.shape), str(v.dtype)] for k, v in flat.items()}
out["combine"] = dr._combine({"a": 5.0, "b": 1.0}, {"a": 8.0, "c": 2.0},
                             mult_layer=7, mult_outer=3,
                             fixed={"a": 0.5, "d": 1.0})
mesh_mod.make_production_mesh = lambda multi_pod=False: mesh_mod.make_mesh(
    (4, 2), ("data", "model"))
dr.make_production_mesh = mesh_mod.make_production_mesh
for s in ("train_4k", "prefill_32k"):
    cb.SHAPE_BY_NAME[s] = dataclasses.replace(cb.SHAPE_BY_NAME[s],
                                              seq_len=64, global_batch=8)
out["collectives"] = {}
for arch, s in CELLS:
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dr.run_cell(arch, s, multi_pod=False,
                          out_dir=tempfile.mkdtemp(), force=True)
    assert rec["status"] == "ok", rec
    out["collectives"][arch + "/" + s] = {
        k: v for k, v in rec["costs_per_device"].items()
        if k.startswith(("wire:", "count:"))}
    if (arch, s) == ("chatglm3-6b", "train_4k"):
        out["chatglm_args"] = rec["memory"]["argument_bytes"]
        out["chatglm_accum"] = rec["meta"]["grad_accum"]
cfg = get_config("llama31-8b")
mesh = mesh_mod.make_debug_mesh((1, 1))
ctx = make_context(cfg, mesh, "prefill", batch_size=1)
out["prefill"] = {}
for n in (1, 2):
    pcfg = dr._probe_cfg(cfg, n)
    pctx = DistContext(mesh, ctx.rules, dict(ctx.flags, unroll_scans=True))
    out["prefill"][n] = dr._costs_of(dr._compile_prefill(
        pcfg, mesh, pctx, dr.input_specs(pcfg, "prefill", 1, 512)))["flops"]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    code = f"CELLS = {COLLECTIVE_CELLS!r}\n" + _CHILD
    lines = run_devices(code, 8).splitlines()
    return json.loads([ln for ln in lines if ln.startswith("RESULT ")][-1]
                      .split(" ", 1)[1])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_list_matches_reference(ref):
    buf = io.StringIO()
    with redirect_stdout(buf):
        dryrun.main(["--list"])
    assert buf.getvalue() == ref["list"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grad_accum_and_input_specs_match_reference(ref, arch):
    cfg = effective_config(get_config(arch), tp=16, ep=16)
    for s in SHAPES:
        key = f"{arch}/{s.name}"
        assert dryrun.grad_accum_for(cfg, s, 16) == ref["accum"][key]
        sp = dryrun.input_specs(cfg, s.kind, 4, 64)
        flat = dict(sp.get("state", {}), **{k: v for k, v in sp.items()
                                            if k != "state"})
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in flat.items()}
        assert got == ref["specs"][key], key
        assert all(v.device.type == "meta" for v in flat.values())


def test_combine_matches_reference(ref):
    got = dryrun._combine({"a": 5.0, "b": 1.0}, {"a": 8.0, "c": 2.0},
                          mult_layer=7, mult_outer=3,
                          fixed={"a": 0.5, "d": 1.0})
    assert got == ref["combine"]


def test_argument_bytes_equal_xla(ref):
    """chatglm3-6b train_4k (seq 64 x batch 8) on the (4, 2) mesh: params,
    AdamW's float32 moments, the batch and the step at their shard
    shapes, as XLA's argument_size_in_bytes counts them."""
    mesh = abstract_mesh((4, 2), ("data", "model"))
    cfg = effective_config(get_config("chatglm3-6b"), tp=2, ep=4)
    shape = dataclasses.replace(SHAPE_BY_NAME["train_4k"], seq_len=64,
                                global_batch=8)
    rec = dryrun.dry_run(cfg, shape, mesh, skip_probes=True)
    assert rec["meta"]["grad_accum"] == ref["chatglm_accum"]
    assert rec["memory"]["argument_bytes"] == ref["chatglm_args"]


@pytest.mark.parametrize("arch,shape_name", COLLECTIVE_CELLS)
def test_reckoned_collectives_equal_xla(ref, arch, shape_name):
    """The port's collectives a step (logged plus reckoned) against the
    reference's ``parse_collectives`` of XLA's probes (1 and 2 layers,
    combined the same way): the all-reduces' wire bytes equal.  Counts
    are not held: XLA packs several operands into one tuple all-reduce.
    A prefill's XLA program also all-to-alls the returned KV cache into
    its ``out_shardings`` (sequence over ``model``), a layout of the
    reference's step that the port's does not take."""
    mesh = abstract_mesh((4, 2), ("data", "model"))
    cfg = effective_config(get_config(arch), tp=2, ep=4)
    shape = dataclasses.replace(SHAPE_BY_NAME[shape_name], seq_len=64,
                                global_batch=8)
    tot = dryrun.dry_run(cfg, shape, mesh)["costs_per_device"]
    want = ref["collectives"][f"{arch}/{shape_name}"]
    kinds = {k.split(":")[-1] for k in tot if k.startswith("wire:")
             and k != "wire"}
    assert kinds == {"all-reduce"}, tot
    got = sum(v for k, v in tot.items()
              if k.startswith("wire:") and k.endswith(":all-reduce"))
    assert got == pytest.approx(want["wire:all-reduce"],
                                rel=COLLECTIVE_TOL), (got, want)
    other = {k for k in want if k.startswith("wire:")} - {
        "wire:all-reduce"}
    assert other <= ({"wire:all-to-all"} if shape.kind == "prefill"
                     else set()), want


def test_memory_term_is_a_lower_bound():
    """The roofline's memory term is ``bytes_min``: a train step's
    arguments read once and its parameters and optimizer state written
    back; a decode step's arguments and its logits.  Llama-3.1-8B's
    phase-10 train cell at (1, 1) is then compute-bound, and the
    unfused count, which is no bound, lies above it."""
    mesh = abstract_mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_config("llama31-8b"), n_layers=2)
    train = dryrun.dry_run(
        cfg, dataclasses.replace(SHAPE_BY_NAME["train_4k"], seq_len=512,
                                 global_batch=4), mesh, grad_accum=2)
    parts, tot = train["meta"]["argument_parts"], train["costs_per_device"]
    assert tot["bytes_min"] == (parts["total"] + parts["params"]
                                + parts["opt_state"])
    assert tot["bytes_unfused"] > tot["bytes_min"]
    rf = train["roofline"]
    assert rf["memory_s"] == tot["bytes_min"] / rf["hardware"]["hbm_bw"]
    assert rf["bottleneck"] == "compute"
    dec = dryrun.dry_run(
        cfg, dataclasses.replace(SHAPE_BY_NAME["decode_32k"], seq_len=256,
                                 global_batch=4), mesh)
    logits = 4 * cfg.vocab_size * 2 + 4 * 4       # bf16 logits, int32 pos
    assert dec["costs_per_device"]["bytes_min"] == \
        dec["memory"]["argument_bytes"] + logits
    assert dec["roofline"]["bottleneck"] == "memory"


def test_prefill_probe_flops_near_xla(ref):
    cfg = get_config("llama31-8b")
    mesh = abstract_mesh((1, 1), ("data", "model"))
    ctx = make_context(cfg, mesh, "prefill", batch_size=1)
    _, _, probes = dryrun._forward_probes("prefill", cfg,
                                          dryrun._probe_ctx(ctx), 1, 512, 32)
    for n in (1, 2):
        got, want = probes[f"probe_{n}L"]["flops"], ref["prefill"][str(n)]
        assert abs(got - want) / want < PROBE_FLOP_TOL, (n, got, want)


def test_grid_writes_every_cell(tmp_path):
    """Every cell of the reference's grid gets a record, ok or skipped
    with the reference's reason (argument bytes and reckoned collectives
    only: the probes are the single cells' tests)."""
    from repro.configs import cell_is_runnable as j_runnable
    with redirect_stdout(io.StringIO()):
        dryrun.main(["--arch", "all", "--shape", "all", "--skip-probes",
                     "--out", str(tmp_path)])
    for a in ARCH_IDS:
        for s in SHAPES:
            rec = json.loads((tmp_path / f"{a}__{s.name}__pod16x16.json")
                             .read_text())
            ok, why = j_runnable(a, s.name)
            assert rec["status"] == ("ok" if ok else "skipped"), rec
            if ok:
                assert rec["memory"]["argument_bytes"] > 0
            else:
                assert rec["reason"] == why


# ---------------------------------------------------------------------------
# the port's own identities on the CPU

def _smoke(arch, layers=2):
    return scaled_config(get_smoke_config(arch), dtype="float32",
                         n_layers=layers)


@pytest.mark.parametrize("arch", ["llama31-8b", "gemma3-12b"])
def test_train_flops_equal_the_real_step(arch):
    """At (1, 1) the dry run's FLOPs (probes of 1 and 2 layers, 2
    microbatches, the optimizer) equal FlopCounterMode's count of the
    real train step on the CPU under the same context."""
    cfg = _smoke(arch, 4)
    shape = dataclasses.replace(SHAPE_BY_NAME["train_4k"], seq_len=64,
                                global_batch=4)
    rec = dryrun.dry_run(cfg, shape, abstract_mesh((1, 1), ("data",
                                                            "model")),
                         grad_accum=2)
    params = init_params(cfg, seed=0, device="cpu")
    opt = adamw()
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    step = make_train_step(cfg, opt, grad_accum=2)
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    with use_dist(make_context(cfg, mesh, "train", batch_size=4)):
        real = dryrun.count_flops(lambda: step(params, state, batch, 0))
    assert rec["costs_per_device"]["flops"] == real > 0


def test_decode_flops_and_collectives_equal_the_real_step():
    """Decode at B 4: unsharded at (1, 1), the dry run's FLOPs equal the
    real step's; at (1, 2) its logged collectives equal the mesh's log of
    the real sharded step (one max and two sums a layer)."""
    cfg = _smoke("llama31-8b", 3)
    ctxs = [40, 33, 17, 1]
    shape = dataclasses.replace(SHAPE_BY_NAME["decode_32k"], seq_len=64,
                                global_batch=4)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.tensor([3, 5, 7, 9], dtype=torch.int32)

    def state():
        st = init_decode_state(cfg, 4, 64, device="cpu")
        st["pos"] = torch.tensor(ctxs, dtype=torch.int32)
        return st

    rec = dryrun.dry_run(cfg, shape, abstract_mesh((1, 1), ("data",
                                                            "model")))
    with torch.no_grad():
        real = dryrun.count_flops(
            lambda: decode_step(params, cfg, state(), tokens))
    assert rec["costs_per_device"]["flops"] == real > 0

    rec2 = dryrun.dry_run(cfg, shape, abstract_mesh((1, 2), ("data",
                                                             "model")))
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    ctx = make_context(cfg, mesh, "decode", batch_size=4)
    with torch.no_grad(), use_dist(ctx):
        decode_step(params, cfg, shard_decode_state(state(), ctx), tokens)
    log = mesh.log.summary(0)
    tot = rec2["costs_per_device"]
    assert log == {"all-reduce": {"count": 3 * cfg.n_layers,
                                  "wire_bytes": log["all-reduce"]
                                  ["wire_bytes"]}}
    assert tot["count:logged:all-reduce"] == log["all-reduce"]["count"]
    assert tot["wire:logged:all-reduce"] == pytest.approx(
        log["all-reduce"]["wire_bytes"], rel=1e-12)
