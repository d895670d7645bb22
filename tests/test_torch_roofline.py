"""The port's roofline (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``): ``model_flops`` and the three-term
``roofline`` equal the reference's on every runnable cell when given the
reference's TPU v5e constants (relative 1e-12); the default hardware is
the H100; the collective log's wire bytes equal ``parse_collectives`` on
the reference tests' synthetic HLO; the report's tables are the same
bytes for the same records (the dry-run table's header names the
card)."""
import inspect
import json

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.roofline import analysis as j_analysis
from repro.roofline import parse_collectives
from repro.roofline import report as j_report
from repro_torch.configs import SHAPE_BY_NAME, get_config, runnable_cells
from repro_torch.core.cost_model import H100, TPU_V5E
from repro_torch.distributed.context import CollectiveLog
from repro_torch.roofline import (collectives_of, model_flops, roofline,
                                  total_wire_bytes, wire_bytes)
from repro_torch.roofline import analysis as t_analysis
from repro_torch.roofline import report as t_report

CELLS = runnable_cells()
REL = 1e-12


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (a, b)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_roofline_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh = SHAPE_BY_NAME[shape]
    _close(model_flops(cfg, sh), j_analysis.model_flops(jcfg, sh))
    args = dict(chips=256, per_device_flops=3.1e13,
                per_device_bytes=7.7e11, per_device_wire_bytes=2.9e9)
    t = roofline(cfg, sh, hardware=TPU_V5E, **args)
    j = j_analysis.roofline(jcfg, sh, **args)
    for name in ("compute_s", "memory_s", "collective_s", "model_flops",
                 "hlo_flops_global", "useful_ratio", "bound_s",
                 "roofline_fraction"):
        _close(getattr(t, name), getattr(j, name))
    assert t.bottleneck == j.bottleneck


def test_default_hardware_is_the_h100():
    assert inspect.signature(roofline).parameters["hardware"].default \
        is H100
    cfg = get_config("granite-3-8b")
    t = roofline(cfg, SHAPE_BY_NAME["decode_32k"], chips=256,
                 per_device_flops=5e10, per_device_bytes=6e10,
                 per_device_wire_bytes=7e7)
    np.testing.assert_allclose(t.compute_s, 5e10 / 989e12)
    np.testing.assert_allclose(t.memory_s, 6e10 / 3.35e12)
    np.testing.assert_allclose(t.collective_s, 7e7 / 450e9)
    assert t.details["hardware"] == "h100-sxm"
    # no TPU constant is left in the port's roofline module
    src = inspect.getsource(t_analysis)
    for tpu in ("197e12", "819e9", "50e9"):
        assert tpu not in src, tpu


def test_wire_bytes_match_parse_collectives():
    hlo = """
  %p0 = bf16[16,1024]{1,0} parameter(0)
  %ag = bf16[256,1024]{1,0} all-gather(%p0), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[4,4096]{1,0} all-reduce(%conv), replica_groups=[16,16]<=[256], to_apply=%sum
  %conv = f32[4,4096]{1,0} convert(%p0)
  %a2a = bf16[16,64]{1,0} all-to-all(%slice), dimensions={0}, replica_groups=[1,16]<=[16]
  %slice = bf16[16,64]{1,0} slice(%p0)
"""
    ref = parse_collectives(hlo)
    log = CollectiveLog()
    ranks = tuple(range(16))
    log.record("all-gather", "", ranks, 256 * 1024 * 2)   # its result
    log.record("all-reduce", "sum", ranks, 4 * 4096 * 4)
    log.record("all-to-all", "", ranks, 16 * 64 * 2)
    got = collectives_of(log, 0)
    assert set(got) == set(ref)
    for kind in ref:
        assert got[kind]["count"] == ref[kind]["count"]
        np.testing.assert_allclose(got[kind]["wire_bytes"],
                                   ref[kind]["wire_bytes"], rtol=1e-15)
        np.testing.assert_allclose(
            wire_bytes(kind, {"all-gather": 256 * 1024 * 2,
                              "all-reduce": 4 * 4096 * 4,
                              "all-to-all": 16 * 64 * 2}[kind], 16),
            ref[kind]["wire_bytes"], rtol=1e-15)
    assert total_wire_bytes(got) == pytest.approx(
        sum(v["wire_bytes"] for v in ref.values()), rel=1e-15)
    assert collectives_of(log, 16) == {}          # not a member
    assert wire_bytes("all-reduce", 1e6, 1) == 0.0


def _records(tmp_path):
    recs = [
        {"arch": "chatglm3-6b", "shape": "train_4k", "mesh": "pod16x16",
         "status": "ok",
         "memory": {"argument_bytes": 4.46e9, "temp_bytes": 9.15e9},
         "costs_per_device": {"flops": 2.1e14, "wire": 1.7e11,
                              "wire:reckoned:all-reduce": 1.7e11,
                              "count:reckoned:all-reduce": 672.0},
         "roofline": {"compute_s": 0.2159, "memory_s": 1.886,
                      "collective_s": 0.3877, "bottleneck": "memory",
                      "model_flops": 1.65e16, "useful_ratio": 0.773,
                      "roofline_fraction": 0.088}},
        {"arch": "chatglm3-6b", "shape": "long_500k", "mesh": "pod16x16",
         "status": "skipped", "reason": "pure full-attention arch"},
        {"arch": "mamba2-780m", "shape": "decode_32k", "mesh": "pod16x16",
         "status": "error"},
        {"arch": "chatglm3-6b", "shape": "train_4k", "mesh": "pod2x16x16",
         "status": "ok", "memory": {}, "roofline": {}},
    ]
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json") \
            .write_text(json.dumps(r))
    return str(tmp_path)


def test_report_tables_match_reference(tmp_path):
    d = _records(tmp_path)
    assert t_report.roofline_table(d) == j_report.roofline_table(d)
    assert t_report.collective_breakdown(d, "chatglm3-6b", "train_4k") \
        == j_report.collective_breakdown(d, "chatglm3-6b", "train_4k")
    t_rows = t_report.dryrun_table(d).splitlines()
    j_rows = j_report.dryrun_table(d).splitlines()
    assert t_rows[1:] == j_rows[1:]
    assert "256 H100s" in t_rows[0] and "512 H100s" in t_rows[0]
    assert "80 GB" in t_rows[0] and "chips" not in t_rows[0]
