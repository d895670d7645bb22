"""The configurations' default module (``bench/reference/model.py``): the
parameter layout of both configurations as the benchmark drew it before
the layout moved here, the single draw in the layout's order, and
attention within a window against a mask written out."""
import json
import math
from pathlib import Path

import pytest
import torch

from bench.harness.weights import make_params, model_config
from bench.reference import model as ref
from bench.tests import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GRANITE = [
    ("embed", (49155, 4096), 0.02),
    ("blocks.attn_norm", (40, 4096), 0.0),
    ("blocks.wq", (40, 4096, 32, 128), 0.015625),
    ("blocks.wk", (40, 4096, 8, 128), 0.015625),
    ("blocks.wv", (40, 4096, 8, 128), 0.015625),
    ("blocks.wo", (40, 32, 128, 4096), 0.0017469281074217107),
    ("blocks.mlp_norm", (40, 4096), 0.0),
    ("blocks.w1", (40, 4096, 12800), 0.015625),
    ("blocks.w3", (40, 4096, 12800), 0.015625),
    ("blocks.w2", (40, 12800, 4096), 0.0009882117688026185),
    ("final_norm", (4096,), 0.0),
]
GROK = [
    ("embed", (131072, 6144), 0.02),
    ("blocks.attn_norm", (4, 6144), 0.0),
    ("blocks.wq", (4, 6144, 48, 128), 0.012757759076995721),
    ("blocks.wk", (4, 6144, 8, 128), 0.012757759076995721),
    ("blocks.wv", (4, 6144, 8, 128), 0.012757759076995721),
    ("blocks.wo", (4, 48, 128, 6144), 0.004510548978043952),
    ("blocks.mlp_norm", (4, 6144), 0.0),
    ("blocks.router", (4, 6144, 8), 0.012757759076995721),
    ("blocks.we1", (4, 8, 6144, 32768), 0.012757759076995721),
    ("blocks.we3", (4, 8, 6144, 32768), 0.012757759076995721),
    ("blocks.we2", (4, 8, 32768, 6144), 0.001953125),
    ("final_norm", (6144,), 0.0),
    ("lm_head", (6144, 131072), 0.02),
]


@pytest.mark.parametrize("name,want", [("granite31_8b", GRANITE),
                                       ("grok1_l4", GROK)])
def test_layout_is_the_one_the_weights_were_drawn_in(name, want):
    cfg_file = json.loads((CONFIGS / f"{name}.json").read_text())
    assert "reference" not in cfg_file
    assert ref.leaves(model_config(cfg_file)) == want


@pytest.mark.parametrize("moe", [False, True])
def test_one_draw_in_the_layouts_order(moe):
    model = dict(tiny.MODEL, tie_embeddings=not moe)
    if moe:
        model["moe"] = {"num_experts": 4, "top_k": 2}
    cfg = model_config({"model": model})
    layout = ref.leaves(cfg)
    params = make_params(cfg, 2**31 + 7, "cpu", layout)
    drawn = [(p, s, c) for p, s, c in layout if c != 0.0]
    buf = torch.empty(sum(math.prod(s) for _, s, _ in drawn))
    buf.normal_(generator=torch.Generator().manual_seed(2**31 + 7))
    off = 0
    for path, shape, scale in layout:
        t = params["blocks"][path[7:]] if path.startswith("blocks.") \
            else params[path]
        assert t.shape == shape
        if scale == 0.0:
            assert not t.any()
            continue
        n = math.prod(shape)
        assert torch.equal(t, buf[off:off + n].view(shape) * scale)
        off += n
    assert off == buf.numel()


@pytest.mark.parametrize("window", [0, 1, 5, 40])
def test_windowed_attention_against_a_mask_written_out(window, monkeypatch):
    # blocks of 8 query rows, so a block's window starts inside the keys
    monkeypatch.setattr(ref, "Q_BLOCK", 8)
    g = torch.Generator().manual_seed(3)
    T, H, KH, D = 29, 4, 2, 8
    q, k, v = (torch.randn(T, n, D, generator=g) for n in (H, KH, KH))
    pos = torch.arange(T)
    dist = pos[:, None] - pos[None, :]
    seen = (dist >= 0) & ((dist < window) if window else True)
    kk = k.repeat_interleave(H // KH, dim=1)
    vv = v.repeat_interleave(H // KH, dim=1)
    sc = torch.einsum("thd,shd->hts", q, kk) / math.sqrt(D)
    sc = 30.0 * torch.tanh(sc / 30.0)
    p = torch.softmax(sc.masked_fill(~seen, float("-inf")), dim=-1)
    want = torch.einsum("hts,shd->thd", p, vv)
    got = ref.attention(q, k, v, 30.0, window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_logits_apply_each_layers_window():
    model = dict(tiny.MODEL, n_layers=4, sliding_window=4,
                 local_global_ratio=3)
    cfg = model_config({"model": model})
    params = make_params(cfg, 11, "cpu", ref.leaves(cfg))
    seq = [torch.randint(0, 256, (30,), generator=torch.Generator()
                         .manual_seed(5))]
    keep = [torch.arange(30)]
    windowed = ref.logits_at(params, model, seq, keep)[0]
    causal = ref.logits_at(params, dict(model, sliding_window=0), seq,
                           keep)[0]
    # the rows that see no more keys than the window agree; the others
    # do not
    assert torch.equal(windowed[:4], causal[:4])
    assert not torch.allclose(windowed[4:], causal[4:], atol=1e-3)
