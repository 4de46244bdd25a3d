"""esslint for the port — AST rules over ``src/repro_torch`` (counterpart
of ``repro.analysis.lint``).

* **ESS001** — a cache-mutating helper (:data:`contracts.ESS001_TARGETS`)
  is called with its gating keyword (``slot_mask=`` / ``n_valid=``)
  spelled out, ``None`` included.  Relying on the default is how the
  reference's page-0 aliasing bug shipped: an ungated scatter wrote
  retired slots' rows over live ones.  Opaque ``**kwargs`` stay silent.
* **ESS002** — no host sync in the modules a round, a prefill chunk, a
  pack or an install runs through (:data:`contracts.ESS002_MODULES`).
  Each of these waits for the card, and each breaks a CUDA-graph capture:

  - ``torch.tensor(..., device=...)`` (a pageable copy);
  - ``.item()``, ``.tolist()``, ``.cpu()``;
  - ``.synchronize()`` (a stream, an event, ``torch.cuda``) outside the
    wait sites (:data:`contracts.FETCH_SITES`);
  - ``int()`` / ``float()`` / ``bool()`` of a computed value: a call
    other than host math (``len``, ``min``, ``round``, ...) inside;
  - ``t[i] = 0``, a Python scalar stored through a subscript (use
    ``t[i].fill_(0)``).

  The top-level definitions of :data:`contracts.ESS002_HOST_SIDE` are
  host code by design and exempt as a whole.

Suppression: ``# esslint: disable=ESS002[,ESS001]`` on any line the
flagged node spans, with its reason beside it.  ``python -m
repro_torch.analysis`` lints the tree against an optional baseline.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import pathlib
import re
import tokenize
from typing import Optional

from repro_torch.analysis import contracts as C
from repro_torch.analysis.findings import Finding

ALL_RULES = ("ESS001", "ESS002")

PACKAGE = "repro_torch"

_DISABLE_RE = re.compile(r"#\s*esslint:\s*disable=([A-Z0-9,\s]+)")

_HOST_CASTS = {"int", "float", "bool"}

# argument-free tensor methods that copy to the host and wait
_SYNC_METHODS = {"item", "tolist", "cpu"}

# builtins whose results are host scalars by construction: int() over a
# composition of only these (and of math / numpy calls) is host math, not
# a device sync
_HOST_SAFE_CALLS = {"round", "len", "min", "max", "abs", "sum", "sorted",
                    "divmod", "ord", "pow"}
_HOST_SAFE_MODULES = ("math", "numpy")


@dataclasses.dataclass
class LintConfig:
    """Rule scoping.  The defaults wire the port's contracts; tests use
    ``fixture_config()`` to put standalone snippets in scope."""
    ess001_targets: dict = dataclasses.field(
        default_factory=lambda: dict(C.ESS001_TARGETS))
    ess002_modules: tuple = C.ESS002_MODULES
    host_side: frozenset = C.ESS002_HOST_SIDE
    fetch_sites: frozenset = frozenset(C.FETCH_SITES)
    rules: tuple = ALL_RULES
    # fixtures: the whole file is in ESS002's scope
    force_scope: bool = False


def fixture_config(**overrides) -> LintConfig:
    cfg = LintConfig(force_scope=True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _port_relpath(relpath: str) -> str:
    """A path from ``repro_torch/`` on (drop ``src/`` etc.), as the keys
    of :mod:`repro_torch.analysis.contracts` are written."""
    parts = pathlib.PurePosixPath(relpath.replace("\\", "/")).parts
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
    return "/".join(parts)


def _module_name(relpath: str) -> str:
    parts = pathlib.PurePosixPath(_port_relpath(relpath)).parts
    if parts and parts[-1].endswith(".py"):
        parts = parts[:-1] + (parts[-1][:-3],)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _collect_disables(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                out.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c"; None for anything not a plain name chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_scalar(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (bool, int, float))


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, tree: ast.Module, source: str, relpath: str,
                 config: LintConfig):
        self.cfg = config
        self.relpath = _port_relpath(relpath)
        self.module = _module_name(relpath)
        self.lines = source.splitlines()
        self.disables = _collect_disables(source)
        self.findings: list[Finding] = []
        self.scope: list[str] = []            # qualname stack
        self.aliases: dict[str, str] = {}     # alias -> qualified prefix
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
                for a in n.names:
                    if a.name != "*":
                        self.aliases[a.asname or a.name] = (
                            f"{n.module}.{a.name}")
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.aliases.setdefault(n.name, f"{self.module}.{n.name}")
        self.in_scope = config.force_scope or any(
            fnmatch.fnmatch(self.relpath, p) for p in config.ess002_modules)

    # -- helpers ----------------------------------------------------------

    def _qualname(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def _resolve(self, node: ast.AST) -> Optional[str]:
        """Fully qualified name of a call target, via import aliases."""
        dotted = _dotted(node)
        if dotted is None:
            return None
        root, _, rest = dotted.partition(".")
        base = self.aliases.get(root, root)
        return f"{base}.{rest}" if rest else base

    def _suppressed(self, rule: str, node: ast.AST) -> bool:
        end = getattr(node, "end_lineno", None) or node.lineno
        return any(rule in self.disables.get(ln, ())
                   for ln in range(node.lineno, end + 1))

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if rule not in self.cfg.rules or self._suppressed(rule, node):
            return
        ln = node.lineno
        snippet = (self.lines[ln - 1].strip()
                   if 0 < ln <= len(self.lines) else "")
        self.findings.append(Finding(
            rule=rule, path=self.relpath, line=ln,
            scope=self._qualname(), message=message, snippet=snippet))

    def _host_math(self, call: ast.Call) -> bool:
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id not in self.aliases:
            return fn.id in _HOST_SAFE_CALLS
        resolved = self._resolve(fn)
        return resolved is not None and \
            resolved.split(".")[0] in _HOST_SAFE_MODULES

    def _ess002_applies(self) -> bool:
        return self.in_scope and not (
            self.scope and self.scope[0] in self.cfg.host_side)

    # -- scope tracking ---------------------------------------------------

    def visit_FunctionDef(self, node):                    # noqa: N802
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    # -- ESS001 / ESS002 --------------------------------------------------

    def visit_Call(self, node):                           # noqa: N802
        resolved = self._resolve(node.func)
        self._check_ess001(node, resolved)
        if self._ess002_applies():
            self._check_ess002_call(node, resolved)
        self.generic_visit(node)

    def visit_Assign(self, node):                         # noqa: N802
        if self._ess002_applies() and _is_scalar(node.value) and any(
                isinstance(t, ast.Subscript) for t in node.targets):
            self._emit("ESS002", node,
                       "a Python scalar stored through a subscript is "
                       "copied from the host and waits for the card; use "
                       "t[i].fill_(x)")
        self.generic_visit(node)

    def _check_ess001(self, node: ast.Call, resolved: Optional[str]) -> None:
        if resolved not in self.cfg.ess001_targets:
            return
        required = self.cfg.ess001_targets[resolved]
        if any(kw.arg is None for kw in node.keywords):   # **kwargs: opaque
            return
        if any(kw.arg == required for kw in node.keywords):
            return
        self._emit("ESS001", node,
                   f"call to {resolved} without explicit {required}= "
                   f"(pass {required}=None to assert the ungated mode "
                   f"is intended)")

    def _check_ess002_call(self, node: ast.Call,
                           resolved: Optional[str]) -> None:
        fn = node.func
        if resolved == "torch.tensor" and any(
                kw.arg == "device" for kw in node.keywords):
            self._emit("ESS002", node,
                       "torch.tensor(..., device=) copies from pageable "
                       "host memory and waits; build on the host and "
                       "upload, or fill_ a persistent tensor")
            return
        if isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
            site = f"{self.relpath}::{self._qualname()}"
            if site not in self.cfg.fetch_sites:
                self._emit("ESS002", node,
                           "a wait outside the allowlisted fetch sites "
                           "breaks the one-fetch contract")
            return
        if (isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS
                and not node.args and not node.keywords):
            self._emit("ESS002", node,
                       f".{fn.attr}() forces a device->host sync")
            return
        # int(f(x)) / bool(t.any()): casting a computed value syncs.  A
        # plain int(x[i]) over host data is fine, as is host math built
        # only from _HOST_SAFE_CALLS (round / len / max ...).
        if (isinstance(fn, ast.Name) and fn.id in _HOST_CASTS
                and fn.id not in self.aliases
                and len(node.args) == 1 and not node.keywords):
            inner = [sub for sub in ast.walk(node.args[0])
                     if isinstance(sub, ast.Call)]
            host_safe = all(self._host_math(c) for c in inner)
            if not inner or host_safe:
                return
            self._emit("ESS002", node,
                       f"{fn.id}() on a computed value is an implicit "
                       f"device->host sync; fetch via the round's packed "
                       f"device_get instead")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, relpath: str,
                config: Optional[LintConfig] = None) -> list[Finding]:
    config = config or LintConfig()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="ESS000", path=_port_relpath(relpath),
                        line=e.lineno or 0, scope="<module>",
                        message=f"syntax error: {e.msg}")]
    linter = _ModuleLinter(tree, source, relpath, config)
    linter.visit(tree)
    return linter.findings


def lint_file(path, root,
              config: Optional[LintConfig] = None) -> list[Finding]:
    path = pathlib.Path(path)
    rel = path.relative_to(root).as_posix() if root else path.as_posix()
    return lint_source(path.read_text(), rel, config)


def lint_tree(root, subdir: str = "src/repro_torch",
              config: Optional[LintConfig] = None) -> list[Finding]:
    """Lint every ``*.py`` under ``root/subdir`` (repo-relative paths in
    the findings)."""
    root = pathlib.Path(root)
    findings: list[Finding] = []
    for path in sorted((root / subdir).rglob("*.py")):
        findings.extend(lint_file(path, root, config))
    return findings


def ess002_modules(package_dir) -> list[pathlib.Path]:
    """The files of ``package_dir`` (the ``repro_torch`` directory) in
    ESS002's scope, sorted."""
    package_dir = pathlib.Path(package_dir)
    found = []
    for p in package_dir.rglob("*.py"):
        rel = f"{PACKAGE}/{p.relative_to(package_dir).as_posix()}"
        if any(fnmatch.fnmatch(rel, pat) for pat in C.ESS002_MODULES):
            found.append(p)
    return sorted(found)


def host_syncs(source: str, relpath: str = "<source>") -> list[str]:
    """``scope:line`` of each ESS002 host sync in ``source`` (the whole
    file in scope; ``scope`` the top-level definition), inline disables
    honoured and the host-side definitions exempt.  ``relpath`` places
    the source in the tree, so the fetch sites' own waits pass."""
    cfg = fixture_config(rules=("ESS002",))
    return [f"{f.scope.split('.')[0]}:{f.line}"
            for f in lint_source(source, relpath, cfg)]
