"""Operations and bytes against rows worked by hand: causal, within a
window, and summed over layers of different windows; the harness's
window rule against the port's; the two configurations' counts over
fixed plans against the values the counts gave before windows."""
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench.harness.flops import (_window_pages, attn_bound_s, attn_layer,
                                 params_per_row, step_flops, step_work)
from bench.harness.peaks import H100
from bench.harness.weights import model_config
from bench.reference.model import layer_window
from bench.tests import tiny

MODEL = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab_size": 10}
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _chunk(pos, completes=False):
    return SimpleNamespace(positions=np.asarray(pos),
                           completes_prefill=completes)


def _dec(prompt_len, n_generated):
    return SimpleNamespace(prompt_len=prompt_len,
                           generated=[1] * n_generated)


def _plan():
    # a chunk of positions 3, 4, 10 (a two-segment chunk) that completes
    # its prompt, and a decode at context 20
    return SimpleNamespace(prefills=[_chunk([3, 4, 10], True)],
                           decodes=[_dec(17, 3)])


def test_step_work_by_hand():
    w = step_work(_plan(), page=4)
    assert w.rows == 4
    assert w.keys() == (4 + 5 + 11) + 20
    assert w.pages() == 3 + 5         # ceil(11 / 4) + ceil(20 / 4)
    assert w.sampled == 2 and w.seqs == 2


def test_windowed_keys_and_pages_by_hand():
    # a contiguous chunk at 20..23, window 4, pages of 4: each row sees 4
    # keys; together they read keys 17..23, pages 4 and 5
    w = step_work(SimpleNamespace(prefills=[_chunk(range(20, 24))],
                                  decodes=[]), page=4)
    assert (w.keys(4), w.pages(4)) == (16, 2)
    assert (w.keys(), w.pages()) == (21 + 22 + 23 + 24, 6)
    # a chunk of two segments with a gap, 3, 4 | 20, 21: keys 0..3, 1..4,
    # 17..20, 18..21; pages 0, 1 and 4, 5 (2 and 3 are in the gap)
    w = step_work(SimpleNamespace(prefills=[_chunk([3, 4, 20, 21])],
                                  decodes=[]), page=4)
    assert (w.keys(4), w.pages(4)) == (4 + 4 + 4 + 4, 4)
    assert (w.keys(), w.pages()) == (4 + 5 + 21 + 22, 6)
    # decode rows at contexts 20, 3 and 9, window 8: keys 12..19 (pages 3,
    # 4), 0..2 (page 0), 1..8 (pages 0..2)
    w = step_work(SimpleNamespace(prefills=[], decodes=[
        _dec(19, 1), _dec(3, 0), _dec(8, 1)]), page=4)
    assert (w.keys(8), w.pages(8)) == (8 + 3 + 8, 2 + 1 + 3)
    assert (w.keys(), w.pages()) == (20 + 3 + 9, 5 + 1 + 3)
    # a window wider than every context is no window
    assert (w.keys(64), w.pages(64)) == (w.keys(), w.pages())


@pytest.mark.parametrize("seed", range(4))
def test_windowed_pages_against_a_set_of_pages(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        pos = np.unique(rng.integers(0, 300, size=rng.integers(1, 40)))
        window, page = int(rng.integers(1, 80)), int(rng.integers(1, 20))
        pages = {k // page for p in pos
                 for k in range(max(0, p - window + 1), p + 1)}
        assert _window_pages(rng.permutation(pos), window, page) \
            == len(pages)


@pytest.mark.parametrize("sw,ratio", [(0, 0), (16, 0), (16, 1), (16, 3),
                                      (0, 3), (128, 5)])
def test_window_rule_is_the_ports(sw, ratio):
    from repro_torch.models.model import _layer_windows
    cfg = dataclasses.replace(model_config({"model": tiny.MODEL}),
                              n_layers=12, sliding_window=sw,
                              local_global_ratio=ratio)
    model = {"sliding_window": sw, "local_global_ratio": ratio}
    assert [layer_window(model, l) for l in range(12)] \
        == _layer_windows(cfg, 12)


def test_attention_counts_by_hand():
    w = step_work(_plan(), page=4)
    a = attn_layer(w, MODEL, 4, 0)
    assert a["flops"] == 4 * 4 * 2 * 40
    # q and output: 2 * 4 rows * 4 heads * 2; K and V: 2 * 8 pages * 4 *
    # 2 heads * 2, all bf16
    assert a["bytes"] == 2 * (2 * 4 * 4 * 2 + 2 * 8 * 4 * 2 * 2)


def test_step_flops_by_hand():
    w = step_work(_plan(), page=4)
    per_row = 8 * (4 + 2 * 2) * 2 + 4 * 2 * 8 + 3 * 8 * 16
    assert params_per_row(MODEL, 0) == per_row
    want = 2 * (2 * per_row * 4 + 4 * 4 * 2 * 40) + 2 * 8 * 10 * 2
    assert step_flops(w, MODEL, page=4) == want


def test_windowed_layers_are_counted_at_their_window():
    # four layers, LLLG at window 4: three at 4 + 4 + 4 + 4 keys (the
    # decode at context 20 sees 4), one at all 40
    model = dict(MODEL, n_layers=4, sliding_window=4, local_global_ratio=3)
    w = step_work(_plan(), page=4)
    per_row = params_per_row(model, 0)
    keys = [16, 16, 16, 40]
    want = sum(2 * per_row * 4 + 4 * 4 * 2 * k for k in keys) \
        + 2 * 8 * 10 * 2
    assert step_flops(w, model, page=4) == want
    # pages of a local layer: the chunk's keys 0..4 and 7..10 (pages
    # 0..2) and the decode's 16..19 (page 4), 3 + 1; the global's 3 + 5
    peaks = {"bf16_flops": 1e12, "hbm_bytes_s": 1.0}
    byt = [2 * (2 * 4 * 4 * 2 + 2 * p * 4 * 2 * 2) for p in (4, 4, 4, 8)]
    assert attn_bound_s(w, model, 4, peaks) == pytest.approx(sum(byt))


def test_a_modules_counts_are_used():
    w = step_work(_plan(), page=4)
    ref = SimpleNamespace(
        params_per_row=lambda model, l: 100.0 * (l + 1),
        attn_layer=lambda work, model, page, l: {"flops": 10.0 * l,
                                                  "bytes": 1.0})
    assert step_flops(w, MODEL, 4, ref) == (2 * 100 * 4 + 0) \
        + (2 * 200 * 4 + 10) + 2 * 8 * 10 * 2
    # layer 0: bytes over bandwidth; layer 1: its operations
    assert attn_bound_s(w, MODEL, 4, {"bf16_flops": 1.0,
                                      "hbm_bytes_s": 1e9}, ref) \
        == pytest.approx(1e-9 + 10.0)


def test_moe_counts_the_routed_experts_only():
    moe = dict(MODEL, moe={"num_experts": 8, "top_k": 2})
    dense = params_per_row(MODEL, 0)
    assert params_per_row(moe, 0) == dense - 3 * 8 * 16 + 8 * 8 \
        + 2 * 3 * 8 * 16


def test_roofline_bound_takes_the_larger_term():
    w = step_work(_plan(), page=4)
    a = attn_layer(w, MODEL, 4, 0)
    peaks = {"bf16_flops": 1.0, "hbm_bytes_s": 1e9}
    assert attn_bound_s(w, MODEL, 4, peaks) == pytest.approx(
        2 * a["flops"])
    peaks = {"bf16_flops": 1e12, "hbm_bytes_s": 1.0}
    assert attn_bound_s(w, MODEL, 4, peaks) == pytest.approx(
        2 * a["bytes"])


def _fixed_plans():
    return [
        SimpleNamespace(prefills=[_chunk(np.arange(0, 512)),
                                  _chunk(np.arange(1000, 1300), True)],
                        decodes=[_dec(17, 3), _dec(4000, 96)]),
        SimpleNamespace(prefills=[_chunk(np.concatenate(
            [np.arange(0, 100), np.arange(700, 760)]), True)],
            decodes=[_dec(129, 0), _dec(100, 30), _dec(1999, 1)]),
        SimpleNamespace(prefills=[], decodes=[_dec(n, 1)
                                              for n in (1, 15, 16, 300)]),
    ]


# step_flops and attn_bound_s (H100 peaks, pages of 16) of the fixed
# plans as the counts gave them before they took windows
BEFORE = {
    "granite31_8b": [(13289991249920.0, 0.00045033991641791043),
                     (2633077063680.0, 0.00018134887164179104),
                     (65584332800.0, 1.878046567164179e-05)],
    "grok1_l4": [(8492208291840.0, 5.299612656716418e-05),
                 (1701569789952.0, 1.9729270447761195e-05),
                 (47950331904.0, 1.917172537313433e-06)],
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_configurations_count_as_before(name):
    model = json.loads((CONFIGS / f"{name}.json").read_text())["model"]
    for plan, (flops, bound) in zip(_fixed_plans(), BEFORE[name]):
        w = step_work(plan, 16)
        assert step_flops(w, model, 16) == flops
        assert attn_bound_s(w, model, 16, H100) == bound
