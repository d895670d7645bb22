"""Shared infrastructure of the port's static-analysis suite (a copy of
``repro.analysis.common``; framework-free).

Findings carry an exact ``file:line`` anchor; suppression is an inline
comment in the grammar

    # repro: allow(<pass>) — <reason>

placed on the flagged line or on the line directly above it.  The
reason is mandatory: a bare ``allow(...)`` does not suppress (the tool
reports it as malformed instead), so every silenced finding documents
why it is intentional.  Suppressed findings are counted and listed in
the JSON report — suppression hides nothing, it only changes
the exit code.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# em-dash or ASCII dashes both accepted; the reason must be non-empty
_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\(([a-z0-9_-]+)\)\s*(?:—|--|-)\s*(\S.*)$")
_ALLOW_BARE_RE = re.compile(r"#\s*repro:\s*allow\(([a-z0-9_-]+)\)")


@dataclass(frozen=True)
class Finding:
    """One invariant violation (or intentional, suppressed exception)."""
    pass_name: str       # "step-hazard" | "lease" | "registry" | ...
    path: str            # repo-relative path
    line: int            # 1-indexed
    code: str            # short machine tag, e.g. "host-side-effect"
    message: str
    suppressed: bool = False
    reason: str = ""     # the allow comment's reason when suppressed

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.location()}: {self.pass_name}/{self.code}{tag}: " \
               f"{self.message}"

    def to_json(self) -> Dict[str, object]:
        return {"pass": self.pass_name, "file": self.path,
                "line": self.line, "code": self.code,
                "message": self.message, "suppressed": self.suppressed,
                **({"reason": self.reason} if self.suppressed else {})}


@dataclass
class SourceFile:
    """One parsed python source with its suppression map."""
    path: Path           # absolute
    rel: str             # repo-relative, forward slashes
    text: str
    tree: ast.AST
    # line -> (pass_name, reason); malformed allows recorded separately
    allows: Dict[int, Tuple[str, str]] = field(default_factory=dict)
    malformed: List[int] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        text = path.read_text()
        sf = cls(path=path, rel=path.relative_to(root).as_posix(),
                 text=text, tree=ast.parse(text, filename=str(path)))
        for i, line in enumerate(text.splitlines(), start=1):
            m = _ALLOW_RE.search(line)
            if m:
                sf.allows[i] = (m.group(1), m.group(2).strip())
            elif _ALLOW_BARE_RE.search(line):
                sf.malformed.append(i)
        return sf

    def allow_for(self, pass_name: str, line: int
                  ) -> Optional[Tuple[str, str]]:
        """Suppression covering ``line``: same line or the line above
        (multi-line allow comments chain upward, so a finding under a
        two-line comment still resolves)."""
        probe = line
        while probe >= max(1, line - 4):
            got = self.allows.get(probe)
            if got is not None:
                return got if got[0] == pass_name else None
            if probe != line and not self._is_comment_line(probe):
                return None
            probe -= 1
        return None

    def _is_comment_line(self, line: int) -> bool:
        lines = self.text.splitlines()
        if not (1 <= line <= len(lines)):
            return False
        return lines[line - 1].lstrip().startswith("#")


def apply_suppressions(findings: List[Finding],
                       sources: Dict[str, SourceFile]) -> List[Finding]:
    """Mark findings covered by a matching allow comment as suppressed."""
    out: List[Finding] = []
    for f in findings:
        sf = sources.get(f.path)
        got = sf.allow_for(f.pass_name, f.line) if sf is not None else None
        if got is not None:
            out.append(Finding(f.pass_name, f.path, f.line, f.code,
                               f.message, suppressed=True, reason=got[1]))
        else:
            out.append(f)
    return out


def load_sources(root: Path, rel_paths: List[str]) -> Dict[str, SourceFile]:
    """Parse the requested files (missing ones are skipped, so the passes
    run unchanged on the fixture mini-repos the tests synthesize)."""
    out: Dict[str, SourceFile] = {}
    for rel in rel_paths:
        p = root / rel
        if p.is_file():
            out[rel] = SourceFile.load(p, root)
    return out


def iter_py_files(root: Path, subdir: str) -> List[Path]:
    base = root / subdir
    if not base.is_dir():
        return []
    return sorted(p for p in base.rglob("*.py") if p.is_file())


def const_str_keys(node: ast.expr) -> Optional[List[Tuple[str, int]]]:
    """String keys (with lines) of a dict literal, or None if the
    expression is not a plain ``{"k": v, ...}`` literal (``**merge``
    entries make the key set statically unknowable)."""
    if not isinstance(node, ast.Dict):
        return None
    keys: List[Tuple[str, int]] = []
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.append((k.value, k.lineno))
        else:
            return None
    return keys
