"""Repo-local call-graph construction for the step-hazard pass (a copy
of ``repro.analysis.callgraph``; framework-free).

Indexes every function/method definition under a source root and
resolves three call forms — bare names, ``self.method(...)`` within a
class, and ``module.attr(...)`` through ``import``/``from`` aliases —
chasing package ``__init__`` re-exports one hop at a time.  External
calls (torch, numpy, stdlib) stay unresolved on purpose: the hazard pass
only needs the functions whose *bodies* run inside the serving step.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import SourceFile


@dataclass
class FuncInfo:
    rel: str                 # file, repo-relative
    qualname: str            # "Engine._step_impl" or "msa_fused"
    node: ast.AST            # FunctionDef | AsyncFunctionDef
    cls: Optional[str]       # enclosing class name


@dataclass
class ModuleInfo:
    rel: str
    sf: SourceFile
    # local name -> ("module.path", original_name | None for module import)
    imports: Dict[str, Tuple[str, Optional[str]]] = field(
        default_factory=dict)
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)


class CallGraph:
    def __init__(self, root: Path, sources: Dict[str, SourceFile]):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}   # module dotted -> info
        self.by_rel: Dict[str, ModuleInfo] = {}
        for rel, sf in sources.items():
            mod = self._module_name(rel)
            mi = ModuleInfo(rel=rel, sf=sf)
            self._index(mi)
            self.modules[mod] = mi
            self.by_rel[rel] = mi

    @staticmethod
    def _module_name(rel: str) -> str:
        # src/repro_torch/serving/engine.py -> repro_torch.serving.engine
        parts = Path(rel).with_suffix("").parts
        if parts and parts[0] == "src":
            parts = parts[1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def _index(self, mi: ModuleInfo) -> None:
        for node in ast.walk(mi.sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mi.imports[a.asname or a.name.split(".")[0]] = \
                        (a.name, None)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    mi.imports[a.asname or a.name] = (node.module, a.name)
        for node in mi.sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi.funcs[node.name] = FuncInfo(mi.rel, node.name, node, None)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        q = f"{node.name}.{sub.name}"
                        mi.funcs[q] = FuncInfo(mi.rel, q, sub, node.name)

    # ------------------------------------------------------------------
    def lookup(self, module: str, name: str, depth: int = 0
               ) -> Optional[FuncInfo]:
        """Find ``name`` in ``module``, chasing ``from X import name``
        re-exports (package ``__init__`` surfaces) up to 4 hops."""
        mi = self.modules.get(module)
        if mi is None or depth > 4:
            return None
        if name in mi.funcs:
            return mi.funcs[name]
        imp = mi.imports.get(name)
        if imp is not None and imp[1] is not None:
            return self.lookup(imp[0], imp[1], depth + 1)
        return None

    def resolve_call(self, mi: ModuleInfo, cls: Optional[str],
                     call: ast.Call) -> Optional[FuncInfo]:
        f = call.func
        mod = self._module_name(mi.rel)
        if isinstance(f, ast.Name):
            return self.lookup(mod, f.id)
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id == "self" and cls:
                return self.lookup(mod, f"{cls}.{f.attr}") \
                    or self.lookup(mod, f.attr)
            if isinstance(base, ast.Name):
                imp = mi.imports.get(base.id)
                if imp is not None and imp[1] is None:
                    return self.lookup(imp[0], f.attr)
                if imp is not None and imp[1] is not None:
                    return self.lookup(f"{imp[0]}.{imp[1]}", f.attr)
        return None

    def reachable(self, entries: List[Tuple[str, str]]
                  ) -> List[FuncInfo]:
        """All repo-local functions reachable from (rel_path, qualname)
        entry points, entry points included, deterministically ordered."""
        seen: Set[Tuple[str, str]] = set()
        order: List[FuncInfo] = []
        work: List[FuncInfo] = []
        for rel, qual in entries:
            mi = self.by_rel.get(rel)
            if mi is not None and qual in mi.funcs:
                work.append(mi.funcs[qual])
        while work:
            fi = work.pop()
            key = (fi.rel, fi.qualname)
            if key in seen:
                continue
            seen.add(key)
            order.append(fi)
            mi = self.by_rel[fi.rel]
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    tgt = self.resolve_call(mi, fi.cls, node)
                    if tgt is not None:
                        work.append(tgt)
        return sorted(order, key=lambda f: (f.rel, f.qualname))
