"""The port's static-analysis suite (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``).

The framework-free passes give the same findings in both packages on the
reference tests' snippets (leases; the registry's renamed counters, laid
out at the port's paths; malformed allow comments); the lattice's
enumeration equals the reference's on the same engine configuration, and
its footprints equal the reference's ``jax.eval_shape`` bytes buffer for
buffer (the fused layout's pack buffer is the port's own layout, with
the CUDA kernel's work units); the replay's predicted bucket keys equal
the reference's prediction on (t, np, k) and the port engine's
``buckets_used`` on the gate workloads exactly (``w`` included).  The
step-hazard pass flags host syncs, tensor-valued branches and host side
effects in synthetic snippets and passes a clean one; on the port's
tree every pass is clean and ``--strict`` exits 0.  One intra-op
thread."""
import dataclasses
import io
import json
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from _h100_costs import cost_model
from repro.analysis import collect_malformed_allows as j_malformed
from repro.analysis import lattice as j_lattice
from repro.analysis import leases as j_leases
from repro.analysis import registry as j_registry
from repro_torch.analysis import collect_malformed_allows, lattice, leases
from repro_torch.analysis import registry, step_hazards
from repro_torch.analysis.__main__ import main as analysis_main

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(findings):
    return sorted((f.path, f.line, f.code, f.message) for f in findings)


# ---------------------------------------------------------------------------
# leases: the reference tests' snippets

LEASE_SNIPPETS = {
    "unreleased_pin_on_early_return": """\
        def admit(bm, req, now, fast):
            slot = bm.allocate(1, now)
            if slot is None:
                return False
            bm.pin([slot], now + 5.0)
            if fast:
                return True
            req.block_slots = [slot]
            return True
    """,
    "balanced_paths": """\
        def admit(bm, req, now, fast):
            slot = bm.allocate(1, now)
            if slot is None:
                return False
            if fast:
                bm.release([slot], now)
                return True
            req.block_slots = [slot]
            return True
    """,
    "unreleased_store_acquire": """\
        def fetch(self, ck, key, tenant, now, fast):
            entry = self.store.acquire(ck, tenant, now)
            if entry is None:
                return False
            if fast:
                return True
            self.host_tier[key] = entry
            self.store.release(ck)
            return True
    """,
    "store_fetch_shaped_paths": """\
        def fetch(self, ck, key, tenant, now, ok):
            entry = self.store.acquire(ck, tenant, now)
            if entry is None:
                return False
            if not ok:
                self.store.drop_corrupt(ck)
                self.store.release(ck)
                return False
            self.host_tier[key] = entry
            self.store.release(ck)
            return True
    """,
}


@pytest.mark.parametrize("name", sorted(LEASE_SNIPPETS))
def test_lease_snippets_match_reference(name):
    src = textwrap.dedent(LEASE_SNIPPETS[name])
    got = _codes(leases.scan_source(src))
    assert got == _codes(j_leases.scan_source(src))
    assert bool(got) == name.startswith("unreleased")


def test_lease_port_tree_clean():
    fs = leases.run(REPO)
    assert [f for f in fs if not f.suppressed] == [], \
        [f.render() for f in fs]
    assert len(leases.TARGET_FILES) == 4 and all(
        (REPO / rel).is_file() and rel.startswith("src/repro_torch/")
        for rel in leases.TARGET_FILES)


# ---------------------------------------------------------------------------
# registry: a counter renamed on one side, at each package's paths

REGISTRY_CASES = {
    "sim_engine": ("serving/server.py", """\
        class _SimEngine:
            def perf_counters(self):
                return {
                    "engine_dispatches": self.steps,
                    "decode_tokens_RENAMED": self.toks,
                }
    """, """\
        SIM_ENGINE_KEYS = frozenset({
            "engine_dispatches",
            "decode_tokens_emitted",
        })
    """),
    "store": ("core/prefix_store.py", """\
        class PrefixStore:
            def counters(self):
                return {
                    "store_hits": self.n_hits,
                    "store_RENAMED": self.n_misses,
                }
    """, """\
        STORE_COUNTER_KEYS = frozenset({
            "store_hits",
            "store_misses",
        })
    """),
}


def _registry_tree(root: Path, pkg: str, test_file: str, case) -> None:
    rel, emitter, frozen = case
    (root / "src" / pkg / rel).parent.mkdir(parents=True)
    (root / "tests").mkdir()
    (root / "src" / pkg / rel).write_text(textwrap.dedent(emitter))
    (root / "tests" / test_file).write_text(textwrap.dedent(frozen))


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_drift_matches_reference(tmp_path, case):
    jroot, troot = tmp_path / "j", tmp_path / "t"
    _registry_tree(jroot, "repro", "test_perf_counters.py",
                   REGISTRY_CASES[case])
    _registry_tree(troot, "repro_torch", "test_torch_perf_counters.py",
                   REGISTRY_CASES[case])

    def norm(fs, pkg, test_file):
        return sorted((f.path.replace(pkg, "PKG").replace(test_file, "T"),
                       f.line, f.code,
                       f.message.replace(pkg, "PKG").replace(test_file, "T"))
                      for f in fs)

    got = norm(registry.run(troot), "src/repro_torch",
               "test_torch_perf_counters.py")
    want = norm(j_registry.run(jroot), "src/repro", "test_perf_counters.py")
    assert got == want
    assert {c for _, _, c, _ in got} == {"unregistered-counter",
                                         "dead-schema-key"}


def test_registry_port_tree_clean_and_bench_not_run():
    fs = registry.run(REPO)
    assert [f for f in fs if not f.suppressed] == [], \
        [f.render() for f in fs]
    assert "bench_schemas" in registry.NOT_RUN


def test_registry_flags_a_dead_doc_reference(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "m.py").write_text(
        "def live_name():\n    pass\n")
    (tmp_path / "README.md").write_text(
        "# x\n\n`gone_name`\n\n## The PyTorch/CUDA port (`x`)\n\n"
        "`live_name` and `gone_name_two`\n\n## After\n\n`gone_after`\n")
    (tmp_path / "PERF.md").write_text("`perf_gone_name`\n")
    fs = registry.run(tmp_path)
    assert sorted((f.path, f.line, f.message.split("`")[1]) for f in fs) \
        == [("PERF.md", 1, "perf_gone_name"),
            ("README.md", 7, "gone_name_two")]


def test_malformed_allows_match_reference(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "tests").mkdir()
    bad = "x = 1  # repro: allow(lease)\ny = 2  # repro: allow(lease) — ok\n"
    (tmp_path / "src" / "repro_torch" / "m.py").write_text(bad)
    (tmp_path / "tests" / "test_torch_m.py").write_text(bad)
    got = _codes(collect_malformed_allows(tmp_path))
    assert got == _codes(j_malformed(tmp_path))
    assert [(p, line) for p, line, _, _ in got] == [
        ("src/repro_torch/m.py", 1), ("tests/test_torch_m.py", 1)]
    assert collect_malformed_allows(REPO) == []


# ---------------------------------------------------------------------------
# the step-hazard pass

def _hits(src):
    return sorted((f.code, f.line) for f in
                  step_hazards.scan_source(textwrap.dedent(src)))


def test_step_hazard_flags_host_syncs():
    src = """\
        import torch

        def step(x, n_heads: int):
            y = torch.sum(x)
            a = y.item()
            b = x.cpu()
            c = int(y)
            d = y.tolist()
            torch.cuda.synchronize()
            return a, b, c, d
    """
    assert _hits(src) == [("host-sync", 5), ("host-sync", 6),
                          ("host-sync", 7), ("host-sync", 8),
                          ("host-sync", 9)]


def test_step_hazard_flags_branches_and_side_effects():
    src = """\
        import time
        import torch

        class E:
            def step(self, x):
                self.count = self.count + 1
                counter.launches += 1
                y = torch.sum(x)
                if y > 0:
                    return y
                t = time.perf_counter()
                return -y * t
    """
    assert _hits(src) == [("host-side-effect", 6), ("host-side-effect", 7),
                          ("nondeterminism", 11), ("tensor-branch", 9)]


def test_step_hazard_clean_function_passes():
    src = """\
        import torch

        def step(x, n_heads, window: int, mask=None):
            # host values: a declared-static name, an int annotation, a
            # shape, a size method, an identity test
            y = x.reshape(n_heads, -1)
            if n_heads > 1 and window > 0 and x.shape[0] > 1:
                y = y * 2
            if mask is not None and x.size(0) == x.numel():
                y = torch.where(mask, y, 0.0)
            for a, b in ((x, y), (y, x)):
                y = y + a * b
            return torch.sum(y)
    """
    assert _hits(src) == []


def test_step_hazard_allow_comment_suppresses():
    src = textwrap.dedent("""\
        def step(x):
            # repro: allow(step-hazard) — host sync: a test's reason
            return x.item()
    """)
    fs = step_hazards.scan_source(src)
    assert [(f.code, f.suppressed, f.reason) for f in fs] == [
        ("host-sync", True, "host sync: a test's reason")]


def test_step_hazard_port_tree():
    """No unsuppressed hazard in what the serving step reaches; the
    suppressed ones are the kernels' Python launch counters and their
    build and load at the first launch."""
    reach = step_hazards.reachable(REPO)
    assert "src/repro_torch/serving/engine.py:Engine._fused_pass" in reach
    assert "src/repro_torch/kernels/msa/msa_fused.py:msa_fused_cuda" in reach
    fs = step_hazards.run(REPO)
    assert [f.render() for f in fs if not f.suppressed] == []
    assert sorted({(Path(f.path).name, f.code) for f in fs}) == [
        ("_build.py", "host-side-effect"), ("_build.py", "nondeterminism"),
        ("msa_decode.py", "host-side-effect"),
        ("msa_fused.py", "host-side-effect"),
        ("msa_prefill.py", "host-side-effect")]
    assert all(f.reason for f in fs)


# ---------------------------------------------------------------------------
# the lattice auditor

def _ecfgs(attn_mode="fused", **kw):
    from repro.serving.engine import EngineConfig as JE
    from repro_torch.serving.engine import EngineConfig as TE
    args = dict(num_pages=64, page_size=16, max_prefills=2, max_chunk=64,
                max_decodes=16, max_blocks_per_seq=24, attn_mode=attn_mode,
                **kw)
    return JE(**args), TE(**args)


@pytest.mark.parametrize("attn_mode,steps", [("fused", 1), ("fused", 4),
                                             ("split", 1)])
def test_enumerate_lattice_matches_reference(attn_mode, steps):
    je, te = _ecfgs(attn_mode)
    got = lattice.enumerate_lattice(te, max_decode_steps=steps)
    want = j_lattice.enumerate_lattice(je, max_decode_steps=steps)
    for key in ("token_buckets", "np_buckets", "k_values"):
        assert got[key] == want[key], key
    if attn_mode == "split":
        assert got["w_buckets"] == want["w_buckets"] == [0]
        assert got["max_trace_keys"] == want["max_trace_keys"]
    else:
        assert got["w_buckets"] == []


@pytest.mark.parametrize("attn_mode", ["fused", "split"])
def test_footprints_match_reference_buffer_for_buffer(attn_mode):
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.configs import scaled_config as j_scaled
    from repro.serving.engine import pack_layout_for as j_pack
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.serving.engine import pack_layout_for
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    jcfg = j_scaled(j_smoke("llama31-8b"), dtype="float32")
    je, te = _ecfgs(attn_mode)
    got, gf = lattice.bucket_footprints(cfg, te, device_budget_bytes=None)
    want, wf = j_lattice.bucket_footprints(jcfg, je, device_budget_bytes=None)
    assert gf == wf == []
    assert got["params_bytes"] == want["params_bytes"]
    assert got["kv_pool_bytes"] == want["kv_pool_bytes"]
    assert len(got["per_bucket"]) == len(want["per_bucket"])
    for g, w in zip(got["per_bucket"], want["per_bucket"]):
        assert (g["t_bucket"], g["np_bucket"], g["k"]) == \
            (w["t_bucket"], w["np_bucket"], w["k"])
        shapes = {
            "residual": ((g["k"] * g["t_bucket"], jcfg.d_model),
                         jnp.float32),
            "attn_scores": ((jcfg.n_heads, g["t_bucket"],
                             g["np_bucket"] * 16), jnp.float32),
            "logits": ((2 + 16, jcfg.vocab_size), jnp.float32)}
        for name, (shape, dt) in shapes.items():
            assert g["buffer_bytes"][name] == \
                int(np.prod(shape)) * jnp.dtype(dt).itemsize, name
        _, jsize = j_pack(je, 1, g["t_bucket"], g["np_bucket"], 0, g["k"])
        assert w["pack_bytes"] == jsize * 4
        if attn_mode == "split":
            assert g["pack_bytes"] == w["pack_bytes"]
            assert g["activation_bytes"] == w["activation_bytes"]
            assert g["total_bytes"] == w["total_bytes"]
        else:
            _, size = pack_layout_for(te, g["t_bucket"], g["np_bucket"], 64,
                                      g["k"])
            assert g["pack_bytes"] == size * 4
            assert g["buffer_bytes"]["attn_scratch"] == \
                8 * g["t_bucket"] * cfg.n_heads * (cfg.head_dim + 2) * 4
    _, fs = lattice.bucket_footprints(cfg, te, device_budget_bytes=1)
    assert fs and all(f.code == "bucket-over-budget" for f in fs)


@pytest.fixture(scope="module")
def gate_keys(_one_thread):
    """The replay's prediction, the reference's on the same
    configuration, and the port engine's buckets_used on the CPU.  The
    reference's replay builds its server with its default cost model,
    which is made the port's default (the H100's rates, ``_h100_costs``)
    for the call: both replays must price the same schedule."""
    import repro.serving.server as j_server
    from repro.analysis.lattice import _gate_setup as j_gate_setup
    from repro.analysis.lattice import _gate_workloads as j_gate_workloads
    from repro.configs import get_smoke_config as j_smoke
    from repro.configs import scaled_config as j_scaled
    from repro.serving.engine import EngineConfig as JE
    from repro_torch.models import init_params
    from repro_torch.serving import AsymCacheServer
    cfg, scfg, ecfg = lattice._gate_setup()
    pred = lattice.predict_trace_keys(cfg, scfg, lattice._gate_workloads(),
                                      ecfg=ecfg)
    _, jscfg, jecfg = j_gate_setup()
    jecfg = dataclasses.replace(jecfg, max_blocks_per_seq=64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_server, "analytic_cost_model",
                   lambda cfg: cost_model(j_server, cfg))
        ref = j_lattice.predict_trace_keys(
            j_scaled(j_smoke("llama31-8b"), dtype="float32"), jscfg,
            j_gate_workloads(), ecfg=JE(**{f.name: getattr(jecfg, f.name)
                                           for f in dataclasses.fields(JE)}))
    srv = AsymCacheServer(cfg, init_params(cfg, seed=0, device="cpu"),
                          scfg, ecfg=ecfg, device="cpu")
    for wl in lattice._gate_workloads():
        srv.run(wl)
    return pred, ref, sorted(srv.engine.buckets_used)


def test_predicted_keys_match_reference(gate_keys):
    pred, ref, _ = gate_keys
    assert sorted({(t, n, k) for t, n, _, k in pred}) == \
        sorted({(t, n, k) for t, n, _, k in ref})
    assert all(w == 0 for _, _, w, _ in ref)


def test_predicted_keys_equal_the_engines_buckets_used(gate_keys):
    pred, _, used = gate_keys
    assert pred == used
    lat = lattice.enumerate_lattice(lattice._gate_setup()[2])
    for t, n, w, k in pred:
        assert t in lat["token_buckets"] and n in lat["np_buckets"]
        assert w >= 64 and w & (w - 1) == 0 and k in lat["k_values"]


def test_collective_probe_counts_the_sharded_step():
    """One all-padding 2-shard step a (t, np) bucket: the fused
    attention's exact merge, one max and two sums a layer, and the
    sharded embedding's and sampling's collectives, the same in every
    bucket."""
    from repro_torch.models import init_params
    cfg, scfg, ecfg = lattice._gate_setup()
    out = lattice.collective_probe(
        cfg, init_params(cfg, seed=0, device="cpu"), scfg, ecfg=ecfg)
    tb, nb = lattice.enumerate_lattice(ecfg)["token_buckets"], \
        lattice.enumerate_lattice(ecfg)["np_buckets"]
    assert len(out) == len(tb) * len(nb)
    counts = {k: {kind: v["count"] for kind, v in s.items()}
              for k, s in out.items()}
    first = next(iter(counts.values()))
    assert all(c == first for c in counts.values())
    assert first["all-reduce"] >= 3 * cfg.n_layers


def test_cli_strict_exits_zero(tmp_path):
    report = tmp_path / "analysis.json"
    with redirect_stdout(io.StringIO()) as out:
        rc = analysis_main(["--root", str(REPO), "--strict", "--no-predict",
                            "--report", str(report)])
    assert rc == 0, out.getvalue()
    rep = json.loads(report.read_text())
    assert rep["summary"]["unsuppressed"] == 0
    assert rep["summary"]["suppressed"] >= 1
    assert rep["lattice"]["max_trace_keys"] >= 1
    assert "registry/bench_schemas" in rep["not_run"]
    assert "not run: registry/bench_schemas" in out.getvalue()
