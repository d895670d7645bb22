"""Registry-drift pass over the port (the counterpart of
``repro.analysis.registry``): counter names, fault sites and the docs
must agree everywhere they are spelled.

Three families of cross-checks, all AST/text-exact with file:line on
both sides of any disagreement:

1. **Emitter vs frozen schema** — the literal dict keys returned by the
   port's ``Engine.perf_counters()``, ``_SimEngine.perf_counters()``,
   ``BlockManager.counters()``, ``BlockManager.control_plane_counts()``
   (seeded from ``policy_op_counts`` in ``core/evictor.py``) and
   ``PrefixStore.counters()`` must equal the frozensets in
   ``tests/test_torch_perf_counters.py`` in *both* directions.

2. **Fault sites** — every ``should_fire("<site>")`` literal in the
   port must name a member of the port's ``FAULT_SITES``
   (``core/faults.py``), and every site must appear in the degradation
   matrix in ``docs/SERVING.md``.

3. **Docs dead references** — backticked snake_case identifiers in the
   README's section on the port and in ``PERF.md`` must still exist in
   the port's sources (``src/repro_torch``, ``tests/test_torch_*.py``,
   ``chip_smoke.py``, ``kernel_ab.py``).

The reference's fourth family, the ``BENCH_*.json`` schemas, has
nothing to read until the port has a benchmark of its own: it is not
run, and the JSON report says so (:data:`NOT_RUN`).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import (Finding, SourceFile, apply_suppressions,
                                   const_str_keys, iter_py_files,
                                   load_sources)

PASS = "registry"

TEST_FILE = "tests/test_torch_perf_counters.py"
FAULTS_FILE = "src/repro_torch/core/faults.py"
EVICTOR_FILE = "src/repro_torch/core/evictor.py"
BM_FILE = "src/repro_torch/core/block_manager.py"

# (emitter file, class, method) -> frozen-set name in TEST_FILE
EMITTER_SCHEMAS: Tuple[Tuple[str, str, str, str], ...] = (
    ("src/repro_torch/serving/engine.py", "Engine", "perf_counters",
     "ENGINE_COUNTER_KEYS"),
    ("src/repro_torch/serving/server.py", "_SimEngine", "perf_counters",
     "SIM_ENGINE_KEYS"),
    ("src/repro_torch/core/block_manager.py", "BlockManager", "counters",
     "BM_COUNTER_KEYS"),
    ("src/repro_torch/core/prefix_store.py", "PrefixStore", "counters",
     "STORE_COUNTER_KEYS"),
)

# (doc, the heading of the section read; None: the whole file)
DOC_FILES = (("README.md", "## The PyTorch/CUDA port"), ("PERF.md", None))

#: the reference's checks this pass does not run, and why
NOT_RUN = {
    "bench_schemas": "the port has no benchmark yet: no BENCH_*.json is "
                     "written by repro_torch, so there is no schema row "
                     "to hold against an emitter",
}

# snake_case identifiers this long are treated as API references when
# they appear in backticks in the docs; shorter/underscore-free words
# are prose.  The lookbehind keeps a match from starting mid-identifier
# (`_select_decode_steps` must not tokenize as `select_decode_steps`)
_DOC_TOKEN_RE = re.compile(
    r"(?<![A-Za-z0-9_])_?[a-z][a-z0-9]*(?:_[a-z0-9*]*)+")
_BACKTICK_RE = re.compile(r"`([^`]+)`")


# ---------------------------------------------------------------------------
# AST extraction helpers

def _module_const_set(sf: SourceFile, name: str
                      ) -> Optional[Tuple[Dict[str, int], int]]:
    """String members (with lines) of ``NAME = frozenset({...})`` /
    tuple / set / list module-level assignment."""
    for node in sf.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
            continue
        if isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id == "frozenset" and len(value.args) == 1:
            value = value.args[0]
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            out: Dict[str, int] = {}
            for e in value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out[e.value] = e.lineno
                else:
                    return None
            return out, node.lineno
    return None


def _find_method(sf: SourceFile, cls: str, meth: str
                 ) -> Optional[ast.FunctionDef]:
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and sub.name == meth:
                    return sub
    return None


def _return_dict_keys(fn: ast.AST) -> Optional[List[Tuple[str, int]]]:
    """Keys of the single ``return {literal}`` in a function."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            keys = const_str_keys(node.value)
            if keys is not None:
                return keys
    return None


def _policy_op_count_keys(sf: SourceFile, findings: List[Finding]
                          ) -> Optional[List[Tuple[str, int]]]:
    """Keys of ``policy_op_counts`` — every return branch must agree."""
    for node in sf.tree.body:
        if isinstance(node, ast.FunctionDef) and \
                node.name == "policy_op_counts":
            branches: List[List[Tuple[str, int]]] = []
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    keys = const_str_keys(sub.value)
                    if keys is not None:
                        branches.append(keys)
            if not branches:
                return None
            first = {k for k, _ in branches[0]}
            for other in branches[1:]:
                if {k for k, _ in other} != first:
                    findings.append(Finding(
                        PASS, sf.rel, other[0][1], "branch-key-mismatch",
                        "policy_op_counts return branches emit different "
                        "key sets — stress gates would see a policy-"
                        "dependent schema"))
            return branches[0]
    return None


def _control_plane_keys(bm_sf: SourceFile, ev_sf: Optional[SourceFile],
                        findings: List[Finding]
                        ) -> Optional[Tuple[List[Tuple[str, int]], int]]:
    """``control_plane_counts`` = policy_op_counts keys + every
    ``out["<k>"] = ...`` subscript assignment in the method body."""
    fn = _find_method(bm_sf, "BlockManager", "control_plane_counts")
    if fn is None:
        return None
    keys: List[Tuple[str, int]] = []
    if ev_sf is not None:
        base = _policy_op_count_keys(ev_sf, findings)
        if base is not None:
            keys.extend(base)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.slice, ast.Constant) and \
                    isinstance(t.slice.value, str):
                keys.append((t.slice.value, node.lineno))
    return keys, fn.lineno


def _diff_schema(label: str, emitted: Sequence[Tuple[str, int]],
                 emit_rel: str, emit_line: int,
                 frozen: Dict[str, int], frozen_rel: str, frozen_line: int,
                 findings: List[Finding]) -> None:
    frozen_keys = set(frozen)
    emitted_keys = {k for k, _ in emitted}
    for key, line in emitted:
        if key not in frozen_keys:
            findings.append(Finding(
                PASS, emit_rel, line, "unregistered-counter",
                f"'{key}' emitted here but absent from {label} "
                f"({frozen_rel}:{frozen_line}) — gates and artifact "
                f"readers will not see it"))
    for key in sorted(frozen_keys - emitted_keys):
        findings.append(Finding(
            PASS, frozen_rel, frozen.get(key, frozen_line), "dead-schema-key",
            f"{label} freezes '{key}' but the emitter "
            f"({emit_rel}:{emit_line}) no longer produces it"))


# ---------------------------------------------------------------------------
# text-universe helpers

def _port_texts(root: Path) -> List[Path]:
    """The port's sources: the package, its tests and its scripts."""
    paths = iter_py_files(root, "src/repro_torch")
    tests = root / "tests"
    if tests.is_dir():
        paths += sorted(tests.glob("test_torch_*.py"))
    paths += [root / f for f in ("chip_smoke.py", "kernel_ab.py")
              if (root / f).is_file()]
    return paths


def _identifier_universe(root: Path) -> Set[str]:
    """Every identifier-ish token in the port's sources and pyproject.
    Deliberately broad: the universe only answers "does this name still
    exist anywhere in the port?"."""
    texts = [p.read_text() for p in _port_texts(root)]
    p = root / "pyproject.toml"
    if p.is_file():
        texts.append(p.read_text())
    tokens: Set[str] = set()
    for t in texts:
        tokens.update(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", t))
    # docs also refer to files/modules by stem (`msa_fused.cu`,
    # `tests/test_torch_models.py`); file names are identifiers too
    for p in _port_texts(root):
        tokens.add(p.stem)
    for sub in ("src/repro_torch", "docs"):
        base = root / sub
        if base.is_dir():
            for p in base.rglob("*"):
                if p.is_file():
                    tokens.add(p.stem)
    return tokens


def _augment_fault_tokens(universe: Set[str], sites: Sequence[str]) -> None:
    # FaultPlan.counts() derives these per-site names with f-strings, so
    # the raw token never appears verbatim in the source
    for site in sites:
        universe.add(f"faults_armed_{site}")
        universe.add(f"faults_fired_{site}")
    universe.add("faults_fired_total")


# ---------------------------------------------------------------------------
# the checks

def _check_schemas(root: Path, sources: Dict[str, SourceFile],
                   findings: List[Finding]) -> None:
    test_sf = sources.get(TEST_FILE)
    if test_sf is None:
        return
    for emit_rel, cls, meth, frozen_name in EMITTER_SCHEMAS:
        sf = sources.get(emit_rel)
        got = _module_const_set(test_sf, frozen_name)
        if sf is None or got is None:
            continue
        frozen, frozen_line = got
        fn = _find_method(sf, cls, meth)
        keys = _return_dict_keys(fn) if fn is not None else None
        if fn is None or keys is None:
            findings.append(Finding(
                PASS, emit_rel, 1, "unextractable-emitter",
                f"{cls}.{meth} no longer returns a plain dict literal — "
                f"the {frozen_name} schema can not be verified"))
            continue
        _diff_schema(frozen_name, keys, emit_rel, fn.lineno,
                     frozen, TEST_FILE, frozen_line, findings)

    # control-plane counts are assembled, not a single literal
    bm_sf = sources.get(BM_FILE)
    got = _module_const_set(test_sf, "CONTROL_PLANE_KEYS")
    if bm_sf is not None and got is not None:
        cp = _control_plane_keys(bm_sf, sources.get(EVICTOR_FILE), findings)
        if cp is not None:
            keys, def_line = cp
            _diff_schema("CONTROL_PLANE_KEYS", keys, bm_sf.rel, def_line,
                         got[0], TEST_FILE, got[1], findings)

    # MONOTONIC_KEYS is a view over the engine schema
    mono = _module_const_set(test_sf, "MONOTONIC_KEYS")
    eng = _module_const_set(test_sf, "ENGINE_COUNTER_KEYS")
    if mono is not None and eng is not None:
        for key, line in mono[0].items():
            if key not in eng[0]:
                findings.append(Finding(
                    PASS, TEST_FILE, line, "dead-schema-key",
                    f"MONOTONIC_KEYS lists '{key}' which is not in "
                    f"ENGINE_COUNTER_KEYS"))


def _fault_sites(sources: Dict[str, SourceFile]
                 ) -> Optional[Tuple[Dict[str, int], int]]:
    sf = sources.get(FAULTS_FILE)
    if sf is None:
        return None
    return _module_const_set(sf, "FAULT_SITES")


def _check_fault_sites(root: Path, sources: Dict[str, SourceFile],
                       findings: List[Finding]) -> None:
    got = _fault_sites(sources)
    if got is None:
        return
    sites, sites_line = got
    # every should_fire("<name>") literal must be a declared site
    for rel, sf in sources.items():
        if not rel.startswith("src/repro_torch/"):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "should_fire" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                name = node.args[0].value
                if name not in sites:
                    findings.append(Finding(
                        PASS, rel, node.lineno, "unknown-fault-site",
                        f"should_fire('{name}') names a site not in "
                        f"FAULT_SITES ({FAULTS_FILE}:{sites_line})"))
    # every declared site must appear in the SERVING.md degradation table
    serving = root / "docs" / "SERVING.md"
    if serving.is_file():
        text = serving.read_text()
        for site, line in sorted(sites.items()):
            if f"`{site}`" not in text:
                findings.append(Finding(
                    PASS, FAULTS_FILE, line, "undocumented-fault-site",
                    f"fault site '{site}' missing from the degradation "
                    f"matrix in docs/SERVING.md"))


def _doc_lines(root: Path, rel: str, heading: Optional[str]
               ) -> List[Tuple[int, str]]:
    """(line number, text) of ``rel``, or of its section under
    ``heading`` (up to the next heading of that level or above)."""
    p = root / rel
    if not p.is_file():
        return []
    lines = list(enumerate(p.read_text().splitlines(), start=1))
    if heading is None:
        return lines
    level = len(heading) - len(heading.lstrip("#"))
    out: List[Tuple[int, str]] = []
    inside = False
    for i, line in lines:
        if line.startswith(heading):
            inside = True
        elif inside and line.startswith("#"):
            hashes = len(line) - len(line.lstrip("#"))
            if 0 < hashes <= level and line[hashes:hashes + 1] == " ":
                break
        if inside:
            out.append((i, line))
    return out


def _check_doc_references(root: Path, universe: Set[str],
                          findings: List[Finding]) -> None:
    in_code = False
    for rel, heading in DOC_FILES:
        for i, line in _doc_lines(root, rel, heading):
            if line.lstrip().startswith("```"):
                in_code = not in_code
                continue
            if in_code:
                continue
            for span in _BACKTICK_RE.findall(line):
                for tok in _DOC_TOKEN_RE.findall(span):
                    tok = tok.rstrip("*_")
                    if len(tok) < 4 or "_" not in tok:
                        continue
                    # version/arxiv tags (`arxiv_2606_02964`) are not
                    # API references
                    if any(seg.isdigit() for seg in tok.split("_")):
                        continue
                    if not any(u.startswith(tok) for u in universe):
                        findings.append(Finding(
                            PASS, rel, i, "dead-doc-reference",
                            f"docs reference `{tok}` but no such "
                            f"identifier exists in the port's sources"))


# ---------------------------------------------------------------------------

def run(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    code_rels = [TEST_FILE, FAULTS_FILE, EVICTOR_FILE]
    code_rels += [rel for rel, _, _, _ in EMITTER_SCHEMAS]
    code_rels += [BM_FILE]
    # should_fire scan wants the whole serving stack
    for p in iter_py_files(root, "src/repro_torch"):
        code_rels.append(p.relative_to(root).as_posix())
    sources = load_sources(root, sorted(set(code_rels)))

    _check_schemas(root, sources, findings)
    _check_fault_sites(root, sources, findings)

    universe = _identifier_universe(root)
    got = _fault_sites(sources)
    if got is not None:
        _augment_fault_tokens(universe, list(got[0]))
    _check_doc_references(root, universe, findings)

    findings = apply_suppressions(findings, sources)
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))
