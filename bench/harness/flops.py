"""Operations and bytes that a step's inputs need, counted from its plan
(the rows and contexts the scheduler chose), whatever kernel does the
work.  These are the yardstick of ``step_mfu`` and ``attn_roofline``.

Per step the recorder keeps, from the plan alone and with no sums: each
prefill chunk's query positions (its array, as the plan holds it), each
decode row's context (its position + 1), and how many rows have their
logits sampled (a chunk that completes its prompt, every decode).  The
counts are sums over those, taken when a metric reads them, for a
window W (0: causal over every earlier key; the kernel's mask is
``q_pos - kv_pos < W``):

* keys: a row at position p sees ``min(p + 1, W)`` keys (``p + 1`` when
  W is 0);
* pages of context read, a sequence: those holding any key that some
  row of the sequence sees (for a chunk with gaps, the union over its
  rows; at W = 0, its deepest row's context in pages).

* Attention of one layer: ``4 * H * D`` operations a visible key (q.k
  and p.v, two each a multiply-add); bytes: q read and the output
  written once (``2 * rows * H * D`` values) and every visible K and V
  page read once a sequence (``2 * pages * page * KH * D`` values), at
  the layer's window (``layer_window`` in ``bench/reference/model.py``).
* The model step: ``2`` operations a parameter a row touches: the q, k,
  v and o projections, the MLP or, for a mixture of experts, the router
  and the top-k experts only; the logits ``2 * d * V`` a sampled row;
  attention as above; summed over the layers.

A configuration's module (``bench/reference/<module>.py``) may bring
its own ``params_per_row(model, layer)`` and ``attn_layer(work, model,
page, layer)``; ``step_flops`` and ``attn_bound_s`` take them from the
module they are given, the ones here otherwise.  Layers whose counts are
equal are summed as one count times their number, so a model whose
layers are alike gives ``L * (one layer)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from bench.reference.model import layer_window


@dataclass
class StepWork:
    chunks: List[np.ndarray]   # each prefill chunk's query positions
    ctxs: List[int]            # each decode row's context
    sampled: int               # rows whose logits are sampled
    page: int                  # tokens a page
    _memo: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def rows(self) -> int:
        """Compute rows (tokens) of the step."""
        return sum(int(p.size) for p in self.chunks) + len(self.ctxs)

    @property
    def seqs(self) -> int:
        return len(self.chunks) + len(self.ctxs)

    def keys(self, window: int = 0) -> int:
        """Visible keys summed over the rows."""
        if ("keys", window) not in self._memo:
            if window > 0:
                n = sum(int(np.minimum(p + 1, window).sum())
                        for p in self.chunks) \
                    + sum(min(c, window) for c in self.ctxs)
            else:
                n = sum(int(p.sum()) + p.size for p in self.chunks) \
                    + sum(self.ctxs)
            self._memo["keys", window] = n
        return self._memo["keys", window]

    def pages(self, window: int = 0) -> int:
        """Context pages summed over the sequences."""
        if ("pages", window) not in self._memo:
            pg = self.page
            if window > 0:
                n = sum(_window_pages(p, window, pg) for p in self.chunks) \
                    + sum((c - 1) // pg - max(0, c - window) // pg + 1
                          for c in self.ctxs)
            else:
                n = sum(-(-(int(p.max()) + 1) // pg) for p in self.chunks) \
                    + sum(-(-c // pg) for c in self.ctxs)
            self._memo["pages", window] = n
        return self._memo["pages", window]


def _window_pages(pos: np.ndarray, window: int, page: int) -> int:
    """Pages of the union of the rows' key ranges, a row at p reading the
    keys ``max(0, p - window + 1) .. p``."""
    p = np.sort(np.asarray(pos, dtype=np.int64))
    lo = np.maximum(p - window + 1, 0) // page
    hi = p // page
    # both ends grow with p: a row's range adds the pages past the last
    # row's highest page
    lo[1:] = np.maximum(lo[1:], hi[:-1] + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def step_work(plan, page: int) -> StepWork:
    """What the counts need of ``plan``, kept with no sums: it runs in
    the timed path, once a step."""
    return StepWork(chunks=[np.asarray(c.positions) for c in plan.prefills],
                    ctxs=[r.prompt_len + len(r.generated)
                          for r in plan.decodes],
                    sampled=sum(1 for c in plan.prefills
                                if c.completes_prefill) + len(plan.decodes),
                    page=page)


def attn_layer(w: StepWork, model: Dict, page: int, layer: int,
               dtype_bytes: int = 2) -> Dict[str, float]:
    """Operations and bytes of one layer's attention launch."""
    H, KH = model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    win = layer_window(model, layer)
    flops = 4.0 * H * D * w.keys(win)
    nbytes = dtype_bytes * (2.0 * w.rows * H * D
                            + 2.0 * w.pages(win) * page * KH * D)
    return {"flops": flops, "bytes": nbytes}


def params_per_row(model: Dict, layer: int) -> float:
    """Parameters one row touches in one layer (outside attention's
    score and value products); alike in every layer."""
    d, H, KH = model["d_model"], model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or d // H
    proj = d * (H + 2 * KH) * D + H * D * d
    moe = model.get("moe")
    if moe:
        mlp = d * moe["num_experts"] + moe["top_k"] * 3 * d * model["d_ff"]
    else:
        mlp = 3 * d * model["d_ff"]
    return float(proj + mlp)


def _counts(ref):
    """The module's ``params_per_row`` and ``attn_layer``, or these."""
    return (getattr(ref, "params_per_row", params_per_row),
            getattr(ref, "attn_layer", attn_layer))


def _over_layers(per_layer, n_layers: int) -> float:
    """Σ over the layers of ``per_layer(l)``, equal values summed as one
    value times their number (at one value: ``L * value``)."""
    seen: Dict[float, int] = {}
    for l in range(n_layers):
        v = per_layer(l)
        seen[v] = seen.get(v, 0) + 1
    return sum(n * v for v, n in seen.items())


def step_flops(w: StepWork, model: Dict, page: int, ref=None) -> float:
    ppr, attn = _counts(ref)
    layers = _over_layers(
        lambda l: 2.0 * ppr(model, l) * w.rows
        + attn(w, model, page, l)["flops"], model["n_layers"])
    return layers + 2.0 * model["d_model"] * model["vocab_size"] \
        * w.sampled


def attn_bound_s(w: StepWork, model: Dict, page: int, peaks: Dict,
                 ref=None) -> float:
    """The least time the chip could take for the step's attention
    launches (one a layer): the larger of operations over peak and bytes
    over bandwidth, a launch."""
    _, attn = _counts(ref)

    def bound(l):
        a = attn(w, model, page, l)
        return max(a["flops"] / peaks["bf16_flops"],
                   a["bytes"] / peaks["hbm_bytes_s"])
    return _over_layers(bound, model["n_layers"])
