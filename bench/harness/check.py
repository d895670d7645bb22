"""The comparison that decides ``correct``.

Outputs are teacher-forced (the port feeds each request its scripted
tokens) and the port samples greedily on the device at every position
it computes a token for: the last prompt position of a turn and each of
its decode positions (``Request.sampled_ids``).  After the window, with
the server's state freed, a sample of the finished requests, drawn from
the seed and holding the one with the longest context, is run through
the plain reference (``logits_at`` of the configuration's module under
``bench/reference``) over its prompt and served tokens.  At each such
position the gap is the reference's best logit less its logit of the
token the port picked; the number compared is the widest gap of the
sample.  It stays near 0 when the port computes what the reference does
(a pick differs only on a near tie, by little) and grows with any error
in the prefill through the paged cache, the recomputed segments, the
decode steps, the routing or the attention.

A session's later turn holds its earlier turns' prompts and outputs
whole, so one reference pass over a session's last finished turn checks
all of its finished turns.

The control (``control=True``): the same positions through the
reference computed in fp8 (``logits_at(..., quant="fp8")``); its
gap is the reference's best logit less the reference's logit of the
token the fp8 pass puts first.  ``control_stats`` puts the control's
numbers in the program's place, and ``verdict`` judges them under the
cell's own limits: a run's control has to come out not correct.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

MIN_SERVED = 400       # checked positions the sample reaches, at least
MIN_SESSIONS = 3
MAX_TOKENS = 32768     # reference tokens in all, the longest included


def _chains(requests) -> Dict[int, List]:
    """Finished requests by session, each session's sorted by context."""
    out: Dict[int, List] = {}
    for r in requests:
        if r.status == "finished" and r.sampled_ids:
            out.setdefault(r.session_id, []).append(r)
    for rs in out.values():
        rs.sort(key=lambda r: r.prompt_len + len(r.generated))
    return out


def sample(requests, seed: int) -> List[List]:
    """Sessions to check (each a list of its finished requests, the last
    the longest), drawn from ``seed``; the longest context first."""
    chains = _chains(requests)
    if not chains:
        return []
    length = lambda sid: (chains[sid][-1].prompt_len
                          + len(chains[sid][-1].generated))
    longest = max(chains, key=lambda sid: (length(sid), -sid))
    rest = sorted(s for s in chains if s != longest)
    random.Random(seed).shuffle(rest)
    picked, tokens, served = [longest], length(longest), 0
    served = sum(len(r.sampled_ids) for r in chains[longest])
    for sid in rest:
        if served >= MIN_SERVED and len(picked) >= MIN_SESSIONS:
            break
        if tokens + length(sid) > MAX_TOKENS:
            continue
        picked.append(sid)
        tokens += length(sid)
        served += sum(len(r.sampled_ids) for r in chains[sid])
    return [chains[s] for s in picked]


def positions(chain) -> Dict:
    """The sequence of a session's last checked turn, and for every
    finished turn the positions the port sampled at and its picks."""
    last = chain[-1]
    seq = np.asarray(last.prompt_tokens + last.generated, np.int64)
    pos, picks = [], []
    for r in chain:
        full = np.asarray(r.prompt_tokens + r.generated, np.int64)
        if not np.array_equal(full, seq[:len(full)]):
            raise ValueError(f"turn {r.rid} is not a prefix of its "
                             f"session's last turn")
        n = min(len(r.sampled_ids), len(r.generated))
        pos.extend(range(r.prompt_len - 1, r.prompt_len - 1 + n))
        picks.extend(r.sampled_ids[:n])
    return {"seq": seq, "pos": np.asarray(pos, np.int64),
            "picks": np.asarray(picks, np.int64)}


def _stats(gaps: np.ndarray, agree: int) -> Dict[str, float]:
    """The numbers a cell may compare, of one set of picks' gaps."""
    return {"max_logit_gap": float(gaps.max()),
            "p99_logit_gap": float(np.percentile(gaps, 99)),
            "mean_logit_gap": float(gaps.mean()),
            "disagree_share": 1.0 - agree / len(gaps)}


def _gaps(ref, picks) -> tuple:
    """Gaps of ``picks`` under the reference logits, and how many picks
    are the reference's best."""
    gaps, agree = [], 0
    for lg, p in zip(ref, picks):
        p = torch.as_tensor(p, device=lg.device).long()
        best = lg.max(dim=-1).values
        gaps.append(best - lg.gather(1, p[:, None]).squeeze(1))
        agree += int((lg.argmax(dim=-1) == p).sum())
    return torch.cat(gaps).float().cpu().numpy(), agree


def compare(logits_at, params, model: Dict, chains, device,
            control: bool = False) -> Dict:
    """The port's picks (and the fp8 control's) under the float32
    reference ``logits_at`` (the configuration's module's), over the
    sampled sessions: the widest gap and the other numbers a cell's
    limits may name."""
    cases = [positions(c) for c in chains]
    seqs = [torch.as_tensor(c["seq"], device=device) for c in cases]
    keep = [torch.as_tensor(c["pos"], device=device) for c in cases]
    ref = logits_at(params, model, seqs, keep)
    out = {"sessions": len(cases),
           "reference_tokens": int(sum(len(c["seq"]) for c in cases)),
           "positions": int(sum(len(c["pos"]) for c in cases))}
    gaps, agree = _gaps(ref, [c["picks"] for c in cases])
    out.update(_stats(gaps, agree))
    if control:
        ctl = logits_at(params, model, seqs, keep, quant="fp8")
        cg, cagree = _gaps(ref, [lq.argmax(dim=-1) for lq in ctl])
        out.update({f"control_{k}": v
                    for k, v in _stats(cg, cagree).items()})
    return out


def control_stats(result: Optional[Dict]) -> Optional[Dict]:
    """The control's numbers under the program's names (None without a
    control), for ``verdict``."""
    if not result or "control_max_logit_gap" not in result:
        return None
    out = {k: v for k, v in result.items() if not k.startswith("control_")}
    out.update({k[len("control_"):]: v for k, v in result.items()
                if k.startswith("control_")})
    return out


def verdict(result: Optional[Dict], limits: Dict[str, float]) -> bool:
    """Every number the cell's limits name is at or under its limit."""
    return bool(result and result.get("positions", 0) > 0
                and all(result.get(k) is not None and result[k] <= v
                        for k, v in limits.items()))
