"""lease-pairing pass: every acquire is dominated by a release (the
counterpart of ``repro.analysis.leases``, over the port's copies of the
control plane; framework-free).

The control plane hands out four kinds of leases — block refs
(``match``/``allocate``), pins, queued COW copies (``fork_into``) and
queued swap halves (``queue_swap_in``) — and the drain audit at the end
of ``serve()`` asserts none leak.  That audit fires minutes into a
benchmark; this pass proves the pairing per function, at lint time, by
walking the AST control flow of ``core/block_manager.py``,
``serving/scheduler.py`` and ``serving/server.py`` (including the
fault-domain paths: rollback-on-OOM, ``_fail_request`` purges).

The acquire/release API pairs are a declarative table
(:data:`LEASE_TABLE`).  A small abstract interpreter tracks outstanding
lease tokens through if/else, loops and try/except; a token is
discharged when the path

* calls a paired release (``release``, or a transfer consumer such as
  ``finish``/``remove``/``drop_copies_to``);
* **escapes** the leased value into owned state (``req.block_slots``,
  a ``self.*`` attribute, an ``.append(...)`` into a tracked queue, or
  a ``return`` — ownership transfers to the caller/container, whose own
  exit paths are checked in turn);
* is guarded by ``if <token> is None`` (a failed ``allocate`` acquired
  nothing — rollback of *other* tokens must still happen, and is
  checked); or
* is a time-bounded ``pin(..., until=...)`` (swept by
  ``unpin_expired``; a pin with NO expiry is a token like any other).

Any ``return``/``raise``/fall-off-the-end reached with an outstanding
token is a finding at that exit's line.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis.common import (Finding, SourceFile, apply_suppressions,
                                   load_sources)

PASS = "lease"

TARGET_FILES = [
    "src/repro_torch/core/block_manager.py",
    "src/repro_torch/core/prefix_store.py",
    "src/repro_torch/serving/scheduler.py",
    "src/repro_torch/serving/server.py",
]


@dataclass(frozen=True)
class LeaseSpec:
    """One acquire API and what discharges it."""
    releases: frozenset            # method names that release the lease
    none_guard: bool = False       # result None == nothing was acquired
    # positional index / kwarg that makes the lease time-bounded
    # (pin's `until`: swept by unpin_expired, no explicit release needed)
    timebound_arg: Optional[int] = None
    timebound_kw: Optional[str] = None


# a lease-acquiring call must be a method of the block manager, the
# prefix store, or a scheduler self-call: `self.allocate`,
# `self.bm.match`, `bm.pin`, `self.store.acquire`.  Same-named methods
# of OTHER receivers (`prefix_trie.match` is a pure trie walk) acquire
# nothing.
_ACQ_RECEIVERS = frozenset({"self", "bm", "store"})


LEASE_TABLE: Dict[str, LeaseSpec] = {
    # fresh block refs: rollback on any admission failure
    "allocate": LeaseSpec(
        releases=frozenset({"release", "finish", "remove", "cancel",
                            "_erase"}),
        none_guard=True),
    # prefix-trie match acquires every hit slot into MatchResult
    "match": LeaseSpec(
        releases=frozenset({"release", "finish", "remove", "cancel"})),
    # internal ref-count bump (block_manager private paths)
    "_acquire": LeaseSpec(
        releases=frozenset({"release", "_erase", "drain_pending_copies",
                            "drop_copies_to"})),
    # pins: released explicitly or time-bounded via until=
    "pin": LeaseSpec(
        releases=frozenset({"unpin", "unpin_expired", "release"}),
        timebound_arg=1, timebound_kw="until"),
    # store fetch pins the entry against eviction until release();
    # a corrupt payload is purged via drop_corrupt before the release
    "acquire": LeaseSpec(
        releases=frozenset({"release"}),
        none_guard=True),
}

# acquire-like APIs that self-manage their lease (they register it in a
# tracked queue whose consumers the table's release sets cover):
#   fork_into      -> bm.pending_copies -> drain_pending_copies/
#                     drop_copies_to release the donor ref
#   queue_swap_in  -> engine swap queues -> consumed by the next
#                     dispatch or purged by _fail_request's swap_out
#   prefetch       -> pin with expiry (checked inside block_manager)
SELF_MANAGED = frozenset({"fork_into", "queue_swap_in", "prefetch",
                          "realize_prefetch", "swap_in"})


@dataclass
class _Token:
    kind: str                  # LEASE_TABLE key
    vars: Set[str]             # names aliasing the acquired value
    line: int

    def ident(self):
        return (self.kind, self.line)


class _State:
    def __init__(self, tokens: Optional[List[_Token]] = None):
        self.tokens: List[_Token] = list(tokens or [])

    def copy(self) -> "_State":
        return _State(self.tokens)

    def merge(self, other: "_State") -> "_State":
        by_id = {t.ident(): _Token(t.kind, set(t.vars), t.line)
                 for t in self.tokens}
        for t in other.tokens:
            if t.ident() in by_id:
                by_id[t.ident()].vars |= t.vars
            else:
                by_id[t.ident()] = _Token(t.kind, set(t.vars), t.line)
        return _State(list(by_id.values()))


def _dotted_name(node: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_method(node: ast.Call) -> Optional[str]:
    """Trailing attribute/function name of a call, if any."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _FnInterp:
    """Path-sensitive walk of one function body."""

    def __init__(self, rel: str, qualname: str):
        self.rel = rel
        self.qualname = qualname
        self.findings: List[Finding] = []

    # -- helpers -------------------------------------------------------
    def _acquires_in(self, node: ast.AST) -> List[ast.Call]:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                m = _call_method(sub)
                if m in LEASE_TABLE and self._receiver_ok(sub) \
                        and not self._is_timebound(sub, m):
                    out.append(sub)
        return out

    @staticmethod
    def _receiver_ok(call: ast.Call) -> bool:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return False
        base = _dotted_name(f.value)
        return base.split(".")[-1] in _ACQ_RECEIVERS if base else False

    @staticmethod
    def _is_timebound(call: ast.Call, kind: str) -> bool:
        spec = LEASE_TABLE[kind]
        if spec.timebound_kw and any(k.arg == spec.timebound_kw
                                     for k in call.keywords):
            return True
        if spec.timebound_arg is not None \
                and len(call.args) > spec.timebound_arg:
            return True
        return False

    def _releases_in(self, node: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                m = _call_method(sub)
                if m is not None:
                    out.add(m)
        return out

    def _discharge_releases(self, state: _State, stmt: ast.AST) -> None:
        rel = self._releases_in(stmt)
        if not rel:
            return
        state.tokens = [t for t in state.tokens
                        if not (LEASE_TABLE[t.kind].releases & rel)]

    def _discharge_escapes(self, state: _State, stmt: ast.AST) -> None:
        """Ownership transfer: the token's value is stored into an
        attribute/subscript, appended into a container, or returned."""
        escaped: Set[str] = set()
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        escaped |= _names_in(sub.value)
            elif isinstance(sub, ast.AugAssign) \
                    and isinstance(sub.target,
                                   (ast.Attribute, ast.Subscript)):
                escaped |= _names_in(sub.value)
            elif isinstance(sub, ast.Call):
                m = _call_method(sub)
                if m in ("append", "add", "extend", "insert", "update"):
                    for a in sub.args:
                        escaped |= _names_in(a)
                elif m in SELF_MANAGED:
                    for a in sub.args:
                        escaped |= _names_in(a)
            elif isinstance(sub, (ast.Return, ast.Yield)) \
                    and sub.value is not None:
                escaped |= _names_in(sub.value)
        if escaped:
            state.tokens = [t for t in state.tokens
                            if not t.vars or not (t.vars & escaped)]

    @staticmethod
    def _propagate_aliases(state: _State, stmt: ast.AST) -> None:
        """``it = iter(fresh)`` makes ``it`` an alias of the lease bound
        to ``fresh`` — escapes through either name discharge it."""
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            rhs = _names_in(stmt.value)
            for t in state.tokens:
                if t.vars & rhs:
                    t.vars.add(stmt.targets[0].id)

    def _bind_tokens(self, state: _State, stmt: ast.AST) -> None:
        """New tokens from acquire calls in this statement, bound to the
        assignment target when there is one."""
        var: Optional[str] = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            var = stmt.targets[0].id
        for call in self._acquires_in(stmt):
            kind = _call_method(call)
            vars_ = {var} if var is not None else set()
            if not vars_ and kind in ("_acquire", "pin") and call.args:
                # self._acquire(slot)/self.pin([slot]) lease their ARGUMENT
                vars_ = set(_names_in(call.args[0]))
            state.tokens.append(_Token(kind, vars_, call.lineno))

    def _none_guarded(self, test: ast.expr, state: _State) -> List[_Token]:
        """Tokens whose variable is compared ``is None`` in this test."""
        out = []
        for sub in ast.walk(test):
            if isinstance(sub, ast.Compare) and len(sub.ops) == 1 \
                    and isinstance(sub.ops[0], ast.Is) \
                    and isinstance(sub.comparators[0], ast.Constant) \
                    and sub.comparators[0].value is None \
                    and isinstance(sub.left, ast.Name):
                for t in state.tokens:
                    spec = LEASE_TABLE[t.kind]
                    if spec.none_guard and sub.left.id in t.vars:
                        out.append(t)
        return out

    def _exit(self, state: _State, node: ast.AST, what: str) -> None:
        for t in state.tokens:
            self.findings.append(Finding(
                PASS, self.rel, getattr(node, "lineno", 1), "leaked-lease",
                f"{self.qualname}: {what} with an outstanding "
                f"{t.kind}() lease from line {t.line} — no paired "
                f"{'/'.join(sorted(LEASE_TABLE[t.kind].releases))} or "
                "ownership transfer on this path"))

    # -- statement walk ------------------------------------------------
    def block(self, stmts: List[ast.stmt], state: _State) -> _State:
        for stmt in stmts:
            state = self.stmt(stmt, state)
        return state

    def stmt(self, node: ast.stmt, state: _State) -> _State:
        if isinstance(node, ast.If):
            self._process_leaf(node.test, state, is_expr=True)
            drop = self._none_guarded(node.test, state)
            s_then = state.copy()
            s_then.tokens = [t for t in s_then.tokens if t not in drop]
            s_then = self.block(node.body, s_then)
            s_else = self.block(node.orelse, state.copy())
            return s_then.merge(s_else)
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            s_body = self.block(node.body, state.copy())
            s_body = self.block(node.orelse, s_body)
            return state.merge(s_body)
        if isinstance(node, ast.Try):
            s_body = self.block(node.body, state.copy())
            merged = s_body
            for h in node.handlers:
                merged = merged.merge(self.block(h.body, state.copy()))
            merged = self.block(node.orelse, merged)
            return self.block(node.finalbody, merged)
        if isinstance(node, ast.With):
            return self.block(node.body, state)
        if isinstance(node, ast.Return):
            self._process_leaf(node, state)
            self._exit(state, node, "return")
            return _State()
        if isinstance(node, ast.Raise):
            self._exit(state, node, "raise")
            return _State()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return state               # nested defs are separate scopes
        self._process_leaf(node, state)
        return state

    def _process_leaf(self, node: ast.AST, state: _State,
                      is_expr: bool = False) -> None:
        """Order matters: a statement that acquires AND escapes/releases
        in one go (``req.slots = self.bm.allocate(...)``) discharges its
        own token."""
        if not is_expr:
            self._bind_tokens(state, node)
            self._propagate_aliases(state, node)
        self._discharge_releases(state, node)
        self._discharge_escapes(state, node)

    def check(self, fn: ast.AST) -> List[Finding]:
        end_state = self.block(fn.body, _State())
        self._exit(end_state, fn.body[-1] if fn.body else fn,
                   "function end")
        return self.findings


# ----------------------------------------------------------------------

def _check_tree(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = node.name
            findings += _FnInterp(sf.rel, qual).check(node)
    return findings


def run(root: Path) -> List[Finding]:
    sources = load_sources(root, TARGET_FILES)
    findings: List[Finding] = []
    for sf in sources.values():
        findings += _check_tree(sf)
    return apply_suppressions(findings, sources)


def scan_source(text: str, rel: str = "fixture.py") -> List[Finding]:
    """Fixture entry point: run the interpreter over a snippet."""
    sf = SourceFile(path=Path("/") / rel, rel=rel, text=text,
                    tree=ast.parse(text))
    from repro_torch.analysis.common import _ALLOW_RE
    for i, line in enumerate(text.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            sf.allows[i] = (m.group(1), m.group(2).strip())
    return apply_suppressions(_check_tree(sf), {rel: sf})
