"""reprolint core for the port (a copy of ``repro/analysis/framework.py``):
the AST lint framework ``repro_torch.analysis.rules`` states the port's
conventions in.

- ``SourceModule``: a parsed file with import-alias resolution
  (``resolve`` maps ``np.asarray`` -> ``numpy.asarray``) and suppression maps;
- ``Rule`` + ``register``: the rule registry the CLI runs;
- ``run`` / ``analyze_source``: drive rules over paths or inline source.

Suppression syntax (parsed from real COMMENT tokens, so string literals
never suppress anything):

    x = f()              # reprolint: ignore[RPL006] host-side by design
    # reprolint: ignore-file[RPL007] this module seeds the global generator

A line-level ``ignore`` silences the named rules on that line only; an
``ignore-file`` anywhere in the file silences them for the whole file.
Everything here is stdlib-only, so the lint needs neither torch nor jax.
"""
from __future__ import annotations

import ast
import io
import tokenize
from collections.abc import Iterable, Iterator
from dataclasses import asdict, dataclass
from pathlib import Path

ERROR = "error"
WARNING = "warning"

_IGNORE = "reprolint:"


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    severity: str            # "error" | "warning"
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def to_dict(self) -> dict:
        return asdict(self)


class SourceModule:
    """A parsed source file plus everything rules need to query it."""

    def __init__(self, path: str, source: str):
        self.path = Path(path).as_posix()
        self.source = source
        self.tree = ast.parse(source, filename=self.path)
        self.aliases = _import_aliases(self.tree)
        self.line_ignores: dict[int, set[str] | None] = {}
        self.file_ignores: set[str] | None = set()
        self._parse_suppressions()

    # ------------------------------------------------------- suppressions --

    def _parse_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except tokenize.TokenError:
            comments = []
        for line, text in comments:
            body = text.lstrip("#").strip()
            if not body.startswith(_IGNORE):
                continue
            directive = body[len(_IGNORE):].strip()
            if directive.startswith("ignore-file"):
                codes = _codes(directive[len("ignore-file"):])
                if codes is None or self.file_ignores is None:
                    self.file_ignores = None        # suppress every rule
                else:
                    self.file_ignores |= codes
            elif directive.startswith("ignore"):
                codes = _codes(directive[len("ignore"):])
                if codes is None:
                    self.line_ignores[line] = None
                else:
                    prev = self.line_ignores.get(line, set())
                    self.line_ignores[line] = (None if prev is None
                                               else prev | codes)

    def suppressed(self, code: str, line: int) -> bool:
        if self.file_ignores is None or code in self.file_ignores:
            return True
        at = self.line_ignores.get(line, set())
        return at is None or code in at

    # ------------------------------------------------------- name queries --

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted path of a Name/Attribute chain with the module's import
        aliases expanded: with ``import jax.numpy as jnp``, the expression
        ``jnp.sum`` resolves to ``"jax.numpy.sum"``. Returns None for
        anything that is not a plain dotted chain."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0])
        if head is not None:
            parts[0] = head
        return ".".join(parts)

    def dotted(self, node: ast.AST) -> str | None:
        """Dotted source text of a Name/Attribute/const-Subscript chain —
        *without* alias expansion (``self.key`` stays ``self.key``). Used
        where the identity of the expression matters, not what it imports."""
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Constant):
                base = self.dotted(node.value)
                return None if base is None else f"{base}[{node.slice.value!r}]"
            return None
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))


def _codes(text: str) -> set[str] | None:
    """``"[RPL001, RPL002]"`` -> {"RPL001", "RPL002"}; no bracket -> None
    (meaning: every rule)."""
    text = text.strip()
    if not (text.startswith("[") and "]" in text):
        return None
    inner = text[1:text.index("]")]
    return {c.strip() for c in inner.split(",") if c.strip()}


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            prefix = "." * node.level + node.module
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{prefix}.{a.name}"
    return aliases


# ------------------------------------------------------------------ rules --

class Rule:
    """One lint rule. Subclasses set the class attributes and implement
    ``check``, yielding ``(node_or_line, message)`` pairs; the framework
    stamps code/severity/path and applies suppressions."""
    code = "RPL000"
    name = "rule"
    severity = ERROR
    description = ""

    def check(self, mod: SourceModule) -> Iterator[tuple[ast.AST | int, str]]:
        raise NotImplementedError

    def findings(self, mod: SourceModule) -> Iterator[Finding]:
        for where, message in self.check(mod):
            if isinstance(where, int):
                line, col = where, 0
            else:
                line = getattr(where, "lineno", 1)
                col = getattr(where, "col_offset", 0)
            if not mod.suppressed(self.code, line):
                yield Finding(rule=self.code, severity=self.severity,
                              path=mod.path, line=line, col=col,
                              message=message)


RULES: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    RULES[cls.code] = cls()
    return cls


# ---------------------------------------------------------------- running --

def iter_py_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part.startswith(".") or part == "__pycache__"
                           for part in f.parts):
                    yield f
        elif p.suffix == ".py":
            yield p


def analyze_source(source: str, path: str = "<string>",
                   rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Run rules over inline source text (the test-fixture entry point)."""
    mod = SourceModule(path, source)
    out: list[Finding] = []
    for rule in (rules if rules is not None else RULES.values()):
        out.extend(rule.findings(mod))
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def run(paths: Iterable[str | Path],
        rules: Iterable[Rule] | None = None) -> tuple[list[Finding], int]:
    """Lint every ``*.py`` under ``paths``. Returns (findings, n_files).
    Unparseable files surface as RPL000 errors rather than crashes."""
    findings: list[Finding] = []
    n = 0
    for f in iter_py_files(paths):
        n += 1
        try:
            source = f.read_text(encoding="utf-8")
            mod = SourceModule(str(f), source)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                rule="RPL000", severity=ERROR, path=Path(f).as_posix(),
                line=getattr(e, "lineno", 1) or 1, col=0,
                message=f"could not parse file: {e.__class__.__name__}"))
            continue
        for rule in (rules if rules is not None else RULES.values()):
            findings.extend(rule.findings(mod))
    return sorted(findings,
                  key=lambda fd: (fd.path, fd.line, fd.col, fd.rule)), n
