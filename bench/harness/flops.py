"""Operations and bytes that a step's inputs need, counted from its plan
(the rows and contexts the scheduler chose), whatever kernel does the
work.  These are the yardstick of ``step_mfu`` and ``attn_roofline``.

Per step the recorder keeps, from the plan alone: the compute rows (a
prefill chunk's positions, one row a decode), the keys each row sees
(causal: a row at position p sees p + 1 keys), the pages of context a
sequence reads (its deepest row's context, in pages), and the rows whose
logits are sampled (a chunk that completes its prompt, every decode).

* Attention of one layer: ``4 * H * D`` operations a visible key (q.k
  and p.v, two each a multiply-add); bytes: q read and the output
  written once (``2 * rows * H * D`` values) and every visible K and V
  page read once a sequence (``2 * pages * page * KH * D`` values).
* The model step: ``2`` operations a parameter a row touches: the q, k,
  v and o projections, the MLP or, for a mixture of experts, the router
  and the top-k experts only; the logits ``2 * d * V`` a sampled row;
  attention as above, every layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class StepWork:
    rows: int            # compute rows (tokens) of the step
    keys: int            # visible keys summed over the rows
    pages: int           # context pages summed over the sequences
    sampled: int         # rows whose logits are sampled
    seqs: int            # sequences in the step


def step_work(plan, page: int) -> StepWork:
    rows = keys = pages = sampled = 0
    for c in plan.prefills:
        p = np.asarray(c.positions, dtype=np.int64)
        rows += p.size
        keys += int(p.sum()) + p.size
        pages += -(-(int(p.max()) + 1) // page)
        sampled += int(c.completes_prefill)
    for r in plan.decodes:
        ctx = r.prompt_len + len(r.generated)
        rows += 1
        keys += ctx
        pages += -(-ctx // page)
        sampled += 1
    return StepWork(rows=rows, keys=keys, pages=pages, sampled=sampled,
                    seqs=len(plan.prefills) + len(plan.decodes))


def attn_layer(w: StepWork, model: Dict, page: int, dtype_bytes: int = 2
               ) -> Dict[str, float]:
    """Operations and bytes of one layer's attention launch."""
    H, KH = model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    flops = 4.0 * H * D * w.keys
    nbytes = dtype_bytes * (2.0 * w.rows * H * D
                            + 2.0 * w.pages * page * KH * D)
    return {"flops": flops, "bytes": nbytes}


def params_per_row(model: Dict) -> float:
    """Parameters one row touches in one layer (outside attention's
    score and value products)."""
    d, H, KH = model["d_model"], model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or d // H
    proj = d * (H + 2 * KH) * D + H * D * d
    moe = model.get("moe")
    if moe:
        mlp = d * moe["num_experts"] + moe["top_k"] * 3 * d * model["d_ff"]
    else:
        mlp = 3 * d * model["d_ff"]
    return float(proj + mlp)


def step_flops(w: StepWork, model: Dict, page: int) -> float:
    L = model["n_layers"]
    per_layer = 2.0 * params_per_row(model) * w.rows \
        + attn_layer(w, model, page)["flops"]
    return L * per_layer + 2.0 * model["d_model"] * model["vocab_size"] \
        * w.sampled


def attn_bound_s(w: StepWork, model: Dict, page: int, peaks: Dict) -> float:
    """The least time the chip could take for the step's attention
    launches (one a layer): the larger of operations over peak and bytes
    over bandwidth, a launch."""
    a = attn_layer(w, model, page)
    return model["n_layers"] * max(a["flops"] / peaks["bf16_flops"],
                                   a["bytes"] / peaks["hbm_bytes_s"])

