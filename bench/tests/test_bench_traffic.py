"""The generator: one seed, one traffic; every seed, the same work in
an order of its own, with clusters; every drawn size inside the mix's
stated range."""
import json

import numpy as np
import pytest

from bench.harness.traffic import BLOCK, draw, generate, load
from bench.tests.tiny import BENCH

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
VOCAB = 49155


def _sizes(sessions):
    turns = [t for s in sessions for t in s.turns]
    return (sorted(len(s.turns) for s in sessions),
            sorted(len(t.output) for t in turns),
            sorted(len(t.next_input) for t in turns),
            sorted(round(t.gap_s, 9) for t in turns))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_sessions(mix):
    tr = load(BENCH / "traffic" / f"{mix}.json")
    a = generate(tr, 2**33 + 7, VOCAB, 40.0)
    b = generate(tr, 2**33 + 7, VOCAB, 40.0)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.arrival == y.arrival
        assert np.array_equal(x.history0, y.history0)
        assert all(np.array_equal(p.output, q.output)
                   for p, q in zip(x.turns, y.turns))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_draw_the_same_work_with_their_own_tokens(mix):
    tr = load(BENCH / "traffic" / f"{mix}.json")
    a = generate(tr, 1, VOCAB, 40.0)
    b = generate(tr, 2, VOCAB, 40.0)
    assert _sizes(a) == _sizes(b)
    assert [[len(t.output) for t in s.turns] for s in a] != \
        [[len(t.output) for t in s.turns] for s in b]
    if tr["arrival"]["process"] == "poisson":
        assert len(a) == len(b)
        assert [s.arrival for s in a] != [s.arrival for s in b]
    assert not np.array_equal(a[0].history0, b[0].history0)


def test_draws_hold_each_blocks_quantiles_in_a_seeded_order():
    spec = {"dist": "exponential", "mean": 2.0}
    n = 20 * BLOCK
    v = draw(spec, n, np.random.default_rng(3))
    w = draw(spec, n, np.random.default_rng(4))
    assert abs(np.mean(v) - 2.0) < 0.05
    # every block holds the same values, each seed in its own order
    blocks = v.reshape(-1, BLOCK)
    assert all(np.array_equal(np.sort(b), np.sort(blocks[0]))
               for b in blocks)
    assert not np.array_equal(v, w)
    # short gaps cluster: some run of 4 holds only the block's shortest
    # half, as in a random stream (an even spread never does)
    short = v < np.median(blocks[0])
    runs = np.convolve(short.astype(int), np.ones(4, int), "valid")
    assert (runs == 4).sum() > 0
    u = draw({"dist": "uniform", "lo": 1, "hi": 4}, 8,
             np.random.default_rng(0))
    assert sorted(u) == [1, 1, 2, 2, 3, 3, 4, 4]
    # a last block shorter than BLOCK holds its own quantiles
    tail = draw({"dist": "uniform", "lo": 0, "hi": 9}, BLOCK + 10,
                np.random.default_rng(0))[BLOCK:]
    assert sorted(tail) == list(range(10))


@pytest.mark.parametrize("mix", MIXES)
def test_sizes_inside_the_stated_ranges(mix):
    tr = load(BENCH / "traffic" / f"{mix}.json")
    for s in generate(tr, 99, VOCAB, 60.0):
        first = len(s.history0) - tr["system_prompt"]
        assert tr["first_input"]["lo"] <= first <= tr["first_input"]["hi"]
        assert tr["turns"]["lo"] <= len(s.turns) <= tr["turns"]["hi"]
        for i, t in enumerate(s.turns):
            assert tr["output"]["lo"] <= len(t.output) <= tr["output"]["hi"]
            last = i == len(s.turns) - 1
            if not last:
                lo, hi = tr["next_input"]["lo"], tr["next_input"]["hi"]
                assert lo <= len(t.next_input) <= hi
            assert t.gap_s >= 0.0
        assert ((s.history0 >= 2) & (s.history0 < VOCAB)).all()


def test_poisson_arrivals_stop_at_the_horizon_and_keep_the_rate():
    tr = {"arrival": {"process": "poisson", "rate_per_s": 2.0},
          "system_prompt": 4,
          "first_input": {"dist": "uniform", "lo": 1, "hi": 2},
          "turns": {"dist": "uniform", "lo": 1, "hi": 1},
          "next_input": {"dist": "uniform", "lo": 0, "hi": 0},
          "output": {"dist": "uniform", "lo": 1, "hi": 1},
          "gap_s": {"dist": "uniform", "lo": 0.0, "hi": 0.0}}
    s = generate(tr, 5, 100, 500.0)
    assert all(0.0 < x.arrival < 500.0 for x in s)
    assert len(s) == 1000
    # the shared system prompt is one token list for every session
    assert all(np.array_equal(x.history0[:4], s[0].history0[:4]) for x in s)


def test_shipped_mixes_name_an_entry_and_a_drain():
    for mix in MIXES:
        tr = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        assert tr["entry"] in ("frontend", "serve")
        assert tr["drain_s"] > 0 and tr["warm_s"] > 0
