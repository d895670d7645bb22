"""Operations and bytes against rows worked by hand."""
from types import SimpleNamespace

import numpy as np
import pytest

from bench.harness.flops import (attn_bound_s, attn_layer, params_per_row,
                                 step_flops, step_work)

MODEL = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab_size": 10}


def _plan():
    # a chunk of positions 3, 4, 10 (a two-segment chunk) that completes
    # its prompt, and a decode at context 20
    chunk = SimpleNamespace(positions=np.array([3, 4, 10]),
                            completes_prefill=True)
    dec = SimpleNamespace(prompt_len=17, generated=[1, 2, 3])
    return SimpleNamespace(prefills=[chunk], decodes=[dec])


def test_step_work_by_hand():
    w = step_work(_plan(), page=4)
    assert w.rows == 4
    assert w.keys == (4 + 5 + 11) + 20
    assert w.pages == 3 + 5           # ceil(11 / 4) + ceil(20 / 4)
    assert w.sampled == 2 and w.seqs == 2


def test_attention_counts_by_hand():
    w = step_work(_plan(), page=4)
    a = attn_layer(w, MODEL, page=4)
    assert a["flops"] == 4 * 4 * 2 * 40
    # q and output: 2 * 4 rows * 4 heads * 2; K and V: 2 * 8 pages * 4 *
    # 2 heads * 2, all bf16
    assert a["bytes"] == 2 * (2 * 4 * 4 * 2 + 2 * 8 * 4 * 2 * 2)


def test_step_flops_by_hand():
    w = step_work(_plan(), page=4)
    per_row = 8 * (4 + 2 * 2) * 2 + 4 * 2 * 8 + 3 * 8 * 16
    assert params_per_row(MODEL) == per_row
    want = 2 * (2 * per_row * 4 + 4 * 4 * 2 * 40) + 2 * 8 * 10 * 2
    assert step_flops(w, MODEL, page=4) == want


def test_moe_counts_the_routed_experts_only():
    moe = dict(MODEL, moe={"num_experts": 8, "top_k": 2})
    dense = params_per_row(MODEL)
    assert params_per_row(moe) == dense - 3 * 8 * 16 + 8 * 8 \
        + 2 * 3 * 8 * 16


def test_roofline_bound_takes_the_larger_term():
    w = step_work(_plan(), page=4)
    a = attn_layer(w, MODEL, page=4)
    peaks = {"bf16_flops": 1.0, "hbm_bytes_s": 1e9}
    assert attn_bound_s(w, MODEL, 4, peaks) == pytest.approx(
        2 * a["flops"])
    peaks = {"bf16_flops": 1e12, "hbm_bytes_s": 1.0}
    assert attn_bound_s(w, MODEL, 4, peaks) == pytest.approx(
        2 * a["bytes"])
