"""step-hazard pass: what a CUDA graph of the serving step forbids (the
counterpart of ``repro.analysis.jit_hazards``).

Everything reachable from ``Engine._step_impl`` (``serving/engine.py``
and the kernels, models and distributed helpers it calls) runs on the
host once a step today, eagerly.  Captured into a CUDA graph it would run
once, at capture, and the graph would replay without the host.  Four
hazard families break that:

* **host side effects** — ``self.x = ...`` mutations, updates of module
  state (a function's launch counter, a module-level cache), ``print`` —
  run once at capture instead of once a step;
* **Python control flow on a tensor's value** — ``if``/``while``/
  ``for``/``assert`` on a tensor reads it on the host (a sync) and bakes
  one branch into the graph;
* **host syncs** — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``int()``/``float()``/``bool()`` of a tensor, ``np.asarray`` of a
  tensor, ``torch.cuda.synchronize()``: the host waits for the device,
  which a capture refuses;
* **nondeterminism** — ``time.*``, ``datetime.*``, ``random.*``,
  ``np.random.*`` give the captured graph the value of capture time.

The reference's ``static_argnums`` check has no counterpart: the port
has no ``jax.jit`` and no static arguments; a step's shapes are its
bucket's.

Tainting is intraprocedural and name-based: parameters are tensors
unless annotated with a host type (``int``, ``bool``, ``str``,
``torch.device``, ...), named in ``STATIC_PARAM_NAMES`` (the bucket dims
and config handles threaded through the step) or defaulted to a literal;
``self``, shape/dtype/device attribute reads, the size methods
(``size()``, ``dim()``, ``numel()``, ...) and calls of repo functions
whose return annotation is a host type are host values; the result of a
``torch.``/``F.`` call is a tensor, but for the host-side helpers
(``torch.cuda.*``, ``torch.is_*``, ``torch.finfo``, ...).

Each finding is a false positive, which the pass is fixed for, or a real
sync or side effect, which carries an allow comment with its reason
(``# repro: allow(step-hazard) — <why>``) until the CUDA graph of the
step removes it.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import CallGraph, FuncInfo
from repro_torch.analysis.common import (_ALLOW_RE, Finding, SourceFile,
                                         apply_suppressions, iter_py_files,
                                         load_sources)

PASS = "step-hazard"

# the serving step: the code a CUDA graph of a bucket would capture
ENTRY_POINTS: List[Tuple[str, str]] = [
    ("src/repro_torch/serving/engine.py", "Engine._step_impl"),
]

# parameter names that carry host values (bucket dims, configs, tiling
# knobs) through functions reachable from the step, where no annotation
# says so
STATIC_PARAM_NAMES = frozenset({
    "self", "cfg", "ecfg", "e", "t_bucket", "np_bucket", "w_bucket",
    "n_iter", "n_it", "page", "page_size", "q_tile", "n_tiles",
    "window", "windows", "softcap", "impl", "eps", "axis", "axis_name",
    "mesh", "n_shards", "n_seqs", "n_heads", "n_kv_heads", "head_dim",
    "block_size", "causal", "dtype", "out_dtype", "fmt", "snap",
    "snap_scale", "sentinel_seq", "layer", "scale", "theta", "split",
    "top_k", "expert_split", "capacity_factor", "dropless", "group",
})

# annotations of host values: a parameter so annotated is not a tensor,
# and a call of a repo function so annotated returns a host value
_HOST_ANNOTATION = re.compile(
    r"(?:Optional\[)?(?:int|float|bool|str|bytes|None|Path|torch\.device|"
    r"torch\.dtype|ctypes\.CDLL|(?:Sequence|Iterable)\[(?:int|str)\]|"
    r"Tuple\[int, \.\.\.\]|Dict\[str, tuple\])\]?")


def _host_annotation(ann: Optional[ast.expr]) -> bool:
    return ann is not None and _HOST_ANNOTATION.fullmatch(
        ast.unparse(ann)) is not None


# attribute reads that return host metadata even on a tensor
_META_ATTRS = frozenset({"shape", "dtype", "ndim", "device", "layout",
                         "is_cuda", "requires_grad", "names"})
# tensor methods whose result is a host value (no sync: metadata)
_META_METHODS = frozenset({"size", "dim", "numel", "element_size",
                           "stride", "is_contiguous", "data_ptr",
                           "get_device", "nelement", "ndimension",
                           "untyped_storage", "storage_offset"})

# dotted-name prefixes whose call results are tensors
_TENSOR_BASES = ("torch.", "F.")
# torch helpers that answer on the host
_HOST_TORCH = ("torch.cuda.", "torch.is_", "torch.finfo", "torch.iinfo",
               "torch.device", "torch.get_", "torch.backends.",
               "torch.Size", "torch.dtype", "torch.no_grad",
               "torch.inference_mode")

# dotted-name prefixes that are nondeterministic on the host
_NONDET_PREFIXES = ("time.", "datetime.", "random.", "np.random.",
                    "numpy.random.", "uuid.", "secrets.")
_NONDET_BARE = frozenset({"perf_counter", "monotonic", "urandom"})

# methods that copy a tensor to the host (and so wait for the device)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def _dotted(node: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _FnChecker(ast.NodeVisitor):
    """Intraprocedural taint walk of one reachable function;
    ``host_funcs`` names the repo functions that return host values."""

    def __init__(self, fi: FuncInfo, rel: str,
                 host_funcs: frozenset = frozenset()):
        self.fi = fi
        self.rel = rel
        self.host_funcs = host_funcs
        self.findings: List[Finding] = []
        self.tainted: Set[str] = set()
        args = fi.node.args
        # names local to the function: its parameters and whatever it
        # binds; an attribute or item set on any other name is module
        # state
        self.local: Set[str] = {a.arg for a in (
            list(args.posonlyargs) + list(args.args)
            + list(args.kwonlyargs) + [args.vararg, args.kwarg]) if a}
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                         ast.Store):
                self.local.add(node.id)
        all_args = list(args.posonlyargs) + list(args.args) \
            + list(args.kwonlyargs)
        defaults = [None] * (len(args.posonlyargs) + len(args.args)
                             - len(args.defaults)) + list(args.defaults)
        literal_default: Set[str] = set()
        for a, d in zip(list(args.posonlyargs) + list(args.args), defaults):
            if isinstance(d, ast.Constant):
                literal_default.add(a.arg)
        for a, d in zip(args.kwonlyargs, list(args.kw_defaults)):
            if isinstance(d, ast.Constant):
                literal_default.add(a.arg)
        for a in all_args:
            if a.arg not in STATIC_PARAM_NAMES \
                    and a.arg not in literal_default \
                    and not _host_annotation(a.annotation):
                self.tainted.add(a.arg)

    # -- findings ------------------------------------------------------
    def _flag(self, node: ast.AST, code: str, msg: str) -> None:
        self.findings.append(Finding(
            PASS, self.rel, getattr(node, "lineno", 1), code,
            f"{self.fi.qualname}: {msg}"))

    # -- taint of an expression ---------------------------------------
    def _t(self, node: Optional[ast.expr]) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False
            return self._t(node.value)
        if isinstance(node, ast.Subscript):
            return self._t(node.value) or self._t(node.slice)
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.startswith(_HOST_TORCH):
                return False
            if name.startswith(_TENSOR_BASES):
                return True
            if name.split(".")[-1] in self.host_funcs:
                return False
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _META_METHODS:
                return False
            if name in ("range", "len", "isinstance", "getattr",
                        "hasattr"):
                return name == "range" and any(self._t(a)
                                               for a in node.args)
            return any(self._t(a) for a in node.args) \
                or any(self._t(k.value) for k in node.keywords) \
                or self._t(node.func)
        if isinstance(node, ast.BinOp):
            return self._t(node.left) or self._t(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._t(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._t(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                   for op in node.ops):
                # `"key" in inp` probes a container's structure and
                # `x is None` an object's identity: host answers
                return False
            return self._t(node.left) \
                or any(self._t(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self._t(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self._t(node.body) or self._t(node.orelse) \
                or self._t(node.test)
        if isinstance(node, ast.Starred):
            return self._t(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._t(node.elt) or any(
                self._t(g.iter) for g in node.generators)
        if isinstance(node, ast.DictComp):
            return self._t(node.key) or self._t(node.value) or any(
                self._t(g.iter) for g in node.generators)
        if isinstance(node, ast.Slice):
            return any(self._t(p) for p in
                       (node.lower, node.upper, node.step))
        if isinstance(node, ast.Dict):
            return any(self._t(v) for v in node.values)
        return False

    def _mark(self, target: ast.expr, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if tainted
             else self.tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e, tainted)

    # -- statement visitors -------------------------------------------
    def _state_write(self, node: ast.AST, tgt: ast.expr, what: str) -> None:
        """Flag a write to ``self.x`` or to an attribute or item of a
        module-level name."""
        if not isinstance(tgt, (ast.Attribute, ast.Subscript)) \
                or not isinstance(tgt.value, ast.Name):
            return
        base = tgt.value.id
        if base == "self" and isinstance(tgt, ast.Attribute):
            self._flag(node, "host-side-effect",
                       f"{what} self.{tgt.attr} inside the step runs once "
                       "at capture, not once a step")
        elif base not in self.local:
            shown = ast.unparse(tgt)
            self._flag(node, "host-side-effect",
                       f"{what} module state {shown} inside the step runs "
                       "once at capture, not once a step")

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        tainted = self._t(node.value)
        for tgt in node.targets:
            self._state_write(node, tgt, "assignment to")
            self._mark(tgt, tainted)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        tgt = node.target
        self._state_write(node, tgt, "in-place update of")
        if isinstance(tgt, ast.Name) and self._t(node.value):
            self.tainted.add(tgt.id)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._mark(node.target, self._t(node.value))

    def visit_If(self, node: ast.If) -> None:
        if self._t(node.test):
            self._flag(node, "tensor-branch",
                       "Python `if` on a tensor's value reads it on the "
                       "host — use torch.where, or decide on the host "
                       "from the plan")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._t(node.test):
            self._flag(node, "tensor-branch",
                       "Python `while` on a tensor's value")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if self._t(node.test):
            self._flag(node, "tensor-branch",
                       "assert on a tensor's value forces a host sync")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if isinstance(node.iter, (ast.Tuple, ast.List)):
            # a literal sequence of values: its items, not a tensor's
            self._mark(node.target, self._t(node.iter))
        elif self._t(node.iter):
            self._flag(node, "tensor-branch",
                       "Python iteration over a tensor reads it on the "
                       "host, one element a time")
        else:
            self._mark(node.target, False)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name == "print":
            self._flag(node, "host-side-effect",
                       "print inside the step runs at capture only")
        if name.startswith(_NONDET_PREFIXES) \
                or name.split(".")[-1] in _NONDET_BARE:
            self._flag(node, "nondeterminism",
                       f"{name}() inside the step gives the graph its "
                       "capture-time value")
        if name in ("int", "float", "bool") \
                and any(self._t(a) for a in node.args):
            self._flag(node, "host-sync",
                       f"{name}() of a tensor waits for the device")
        if name in ("np.asarray", "np.array", "numpy.asarray",
                    "numpy.array") and any(self._t(a) for a in node.args):
            self._flag(node, "host-sync",
                       f"{name}() of a tensor copies it to the host")
        if name == "torch.cuda.synchronize":
            self._flag(node, "host-sync",
                       "torch.cuda.synchronize() inside the step")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS \
                and self._t(node.func.value):
            self._flag(node, "host-sync",
                       f".{node.func.attr}() of a tensor copies it to the "
                       "host and waits for the device")
        self.generic_visit(node)


def _host_funcs(graph: CallGraph) -> frozenset:
    """Names of the repo functions annotated to return a host value."""
    return frozenset(q.split(".")[-1] for mi in graph.modules.values()
                     for q, fi in mi.funcs.items()
                     if _host_annotation(fi.node.returns))


def _check(graph: CallGraph, entries: List[Tuple[str, str]]
           ) -> List[Finding]:
    findings: List[Finding] = []
    host = _host_funcs(graph)
    for fi in graph.reachable(entries):
        checker = _FnChecker(fi, fi.rel, host)
        for stmt in fi.node.body:
            checker.visit(stmt)
        findings += checker.findings
    return findings


def reachable(root: Path) -> List[str]:
    """``file:qualname`` of every function the step reaches."""
    rels = [p.relative_to(root).as_posix()
            for p in iter_py_files(root, "src/repro_torch")]
    graph = CallGraph(root, load_sources(root, rels))
    return [f"{fi.rel}:{fi.qualname}" for fi in graph.reachable(ENTRY_POINTS)]


def run(root: Path) -> List[Finding]:
    rels = [p.relative_to(root).as_posix()
            for p in iter_py_files(root, "src/repro_torch")]
    sources = load_sources(root, rels)
    findings = _check(CallGraph(root, sources), ENTRY_POINTS)
    return apply_suppressions(findings, sources)


def scan_source(text: str, rel: str = "fixture.py") -> List[Finding]:
    """Fixture entry point: every top-level function and method in
    ``text`` is treated as part of the step."""
    root = Path("/")
    sf = SourceFile(path=root / rel, rel=rel, text=text,
                    tree=ast.parse(text))
    for i, line in enumerate(text.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            sf.allows[i] = (m.group(1), m.group(2).strip())
    sources = {rel: sf}
    graph = CallGraph(root, sources)
    findings = _check(graph, [(rel, q) for q in graph.by_rel[rel].funcs])
    return apply_suppressions(findings, sources)
