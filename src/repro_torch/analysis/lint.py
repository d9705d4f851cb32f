"""Repo lint: AST rules for the plan API and the runtime's invariants.

Rules (all purely syntactic — no imports of ``repro_torch`` code, stdlib
``ast`` only, so the linter runs before the tree is importable):

* **L001** — call sites passing deprecated legacy FFT kwargs
  (``mesh=``, ``axis=``, ``natural_order=``, ``decomp=``, ``groups=``,
  ``group_size=``, ``recompute_uncorrectable=``) to the compat shims
  ``repro_torch.kernels.ops.{fft, ifft, fft2, ifft2, ft_fft}``. New code
  builds an :class:`~repro_torch.core.fft.api.FFTSpec` and plans it
  instead. Scope: ``src/repro_torch`` and ``benchmarks_torch`` (tests
  exercise the legacy path on purpose).
* **L002** — raw ``torch.fft.*`` usage outside ``core/fft``: every
  transform must route through the plan API so the auditor's collective
  and volume contracts cover it. Scope: ``src/repro_torch`` minus
  ``core/fft``.
* **L003** — bare ``assert`` used for input validation: an ``assert``
  whose test references a parameter of the enclosing function. Asserts
  vanish under ``python -O``; validation must ``raise ValueError`` with
  the offending value. Internal invariants over locals are fine. Scope:
  ``src/repro_torch``.
* **L004** — plan-executor dispatch (``serve_plan``) in
  ``serve/runtime.py`` where two threads could dispatch a sharded plan at
  once: sharded executors rendezvous across every rank of the mesh, so two
  concurrent dispatches on one rank deadlock the collective. The
  reference serialises them with a lock; the port serialises them with
  one thread a rank, the mesh's dispatch thread (the leader's ``_lead``,
  a follower's ``_follow_loop``). A call is legal in a method that only
  that thread runs — a dispatch thread's own method, or a method every
  call site of which (a ``self.<method>(...)`` call or a thread
  ``target=``) lies in such a method — or on a branch reached only
  without a mesh channel: the body of ``if ….channel is None``, the
  ``else`` of ``if ….channel is not None``, or the statements after an
  ``if ….channel is not None:`` whose body returns or raises.
* **L005** — ``object.__setattr__`` on frozen dataclasses outside
  ``__post_init__`` / ``__init__`` / ``__setstate__``: specs are frozen
  and hashable (they key the plan LRU); mutating one after construction
  corrupts the cache. Scope: ``src/repro_torch``.

Suppression: append ``# noqa: LXXX`` (or bare ``# noqa``) to the line.
Baseline: ``lint_baseline.txt`` next to this module holds fingerprints
(``RULE|path|stripped-line``) of grandfathered findings; the CLI fails
only on findings NOT in the baseline (strict-on-new).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

__all__ = ["LintFinding", "RULES", "lint_file", "lint_tree",
           "load_baseline", "save_baseline", "split_baseline",
           "BASELINE_PATH"]

RULES = {
    "L001": "deprecated legacy FFT kwarg at a kernels.ops call site",
    "L002": "raw torch.fft usage outside core/fft (bypasses the plan API)",
    "L003": "bare assert validating a function parameter (use ValueError)",
    "L004": "serve_plan dispatch off the mesh's dispatch thread in "
            "serve/runtime.py",
    "L005": "object.__setattr__ on a frozen spec outside __post_init__",
}

BASELINE_PATH = pathlib.Path(__file__).with_name("lint_baseline.txt")

_PACKAGE = "repro_torch"
_SCOPES = ("src/repro_torch", "benchmarks_torch")
_RUNTIME = "src/repro_torch/serve/runtime.py"
_OPS_ENTRIES = {"fft", "ifft", "fft2", "ifft2", "ft_fft"}
_OPS_MODULE = f"{_PACKAGE}.kernels.ops"
_DEPRECATED_KWARGS = {"mesh", "axis", "natural_order", "decomp", "groups",
                      "group_size", "recompute_uncorrectable"}
_SETATTR_OK_SCOPES = {"__post_init__", "__init__", "__setstate__"}
# the methods the mesh's dispatch thread of a rank runs
_DISPATCH_THREADS = ("_lead", "_follow_loop")
_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<rules>[A-Z0-9, ]+))?")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One rule violation at a source location. ``fingerprint`` is the
    line-number-free identity used by the baseline, so unrelated edits
    above a grandfathered finding don't resurrect it."""

    rule: str
    path: str           # repo-relative posix path
    line: int
    snippet: str        # stripped source line
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.snippet}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _suppressed(rule: str, line_text: str) -> bool:
    m = _NOQA_RE.search(line_text)
    if not m:
        return False
    rules = m.group("rules")
    if rules is None:
        return True
    return rule in {r.strip() for r in rules.split(",")}


class _Aliases:
    """Import table: local dotted prefix -> canonical dotted module."""

    def __init__(self, tree: ast.AST):
        self.map: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for a in node.names:
                    self.map[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def expand(self, dotted: str) -> str:
        """Rewrite the longest aliased prefix of ``dotted``."""
        parts = dotted.split(".")
        for i in range(len(parts), 0, -1):
            head = ".".join(parts[:i])
            if head in self.map:
                return ".".join([self.map[head]] + parts[i:])
        return dotted


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# -- per-rule checks --------------------------------------------------------


def _check_l001(tree, aliases, emit):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted is None:
            continue
        full = aliases.expand(dotted)
        if not (full.startswith(f"{_OPS_MODULE}.")
                and full.rsplit(".", 1)[-1] in _OPS_ENTRIES):
            # `from repro_torch import kernels; kernels.ops.fft(...)`
            # expands to repro_torch.kernels + ".ops.fft", which the prefix
            # test covers; a bare `ops.fft` with no repro_torch import does
            # not match — good.
            continue
        bad = sorted(k.arg for k in node.keywords
                     if k.arg in _DEPRECATED_KWARGS)
        if bad:
            emit("L001", node,
                 f"deprecated kwarg(s) {', '.join(bad)} passed to "
                 f"{full.removeprefix(_PACKAGE + '.')} — build an FFTSpec "
                 f"and use plan() executors")


def _check_l002(tree, aliases, emit):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        dotted = _dotted(node)
        if dotted is None:
            continue
        full = aliases.expand(dotted)
        # flag the *member* access (torch.fft.fft), not the bare module
        # mention, and only once per chain (outermost Attribute)
        if full.startswith("torch.fft.") and full.count(".") == 2:
            emit("L002", node,
                 f"raw {dotted} bypasses the plan API — use "
                 f"core.fft executors (or add to core/fft)")


def _check_l003(tree, emit):
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        a = fn.args
        params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
        for v in (a.vararg, a.kwarg):
            if v is not None:
                params.add(v.arg)
        params.discard("self")
        params.discard("cls")
        nested = {id(x) for nf in ast.walk(fn)
                  if isinstance(nf, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and nf is not fn for x in ast.walk(nf)}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assert) or id(node) in nested:
                continue
            used = sorted({n.id for n in ast.walk(node.test)
                           if isinstance(n, ast.Name) and n.id in params})
            if used:
                emit("L003", node,
                     f"assert validates parameter(s) {', '.join(used)} — "
                     f"raise ValueError with the offending value instead")


def _self_method(node: ast.AST) -> str | None:
    """``m`` for ``self.m``, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _dispatch_only(cls: ast.ClassDef) -> set[str]:
    """The methods of ``cls`` that only the mesh's dispatch thread runs:
    the dispatch threads' own methods, then every method each call site of
    which (``self.m(...)`` or ``target=self.m``) lies in one of them."""
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    callers: dict[str, set[str]] = {name: set() for name in methods}
    for name, fn in methods.items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                refs = [node.func] + [k.value for k in node.keywords
                                      if k.arg == "target"]
                for ref in refs:
                    m = _self_method(ref)
                    if m in callers:
                        callers[m].add(name)
    only = {m for m in _DISPATCH_THREADS if m in methods}
    grew = True
    while grew:
        grew = False
        for m, who in callers.items():
            if m not in only and who and who <= only:
                only.add(m)
                grew = True
    return only


def _channel_test(test: ast.AST) -> bool | None:
    """For ``….channel is None`` True, for ``….channel is not None``
    False, else None."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Attribute) \
            and test.left.attr == "channel" \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is):
            return True
        if isinstance(test.ops[0], ast.IsNot):
            return False
    return None


def _check_l004(tree, aliases, emit):
    def is_serve_plan(call: ast.Call) -> bool:
        dotted = _dotted(call.func)
        return dotted is not None and \
            aliases.expand(dotted).endswith("serve.specs.serve_plan")

    def visit(node, safe: bool):
        if isinstance(node, ast.Call) and is_serve_plan(node) and not safe:
            emit("L004", node,
                 "serve_plan dispatch off the mesh's dispatch thread — "
                 "concurrent sharded dispatch deadlocks the collective "
                 "(dispatch from the dispatch thread's methods, or on a "
                 "branch without a mesh channel)")
        if isinstance(node, ast.ClassDef):
            only = _dispatch_only(node)
            for c in node.body:
                visit(c, safe or getattr(c, "name", None) in only)
            return
        if isinstance(node, ast.If):
            no_channel = _channel_test(node.test)
            visit(node.test, safe)
            block(node.body, safe or no_channel is True)
            block(node.orelse, safe or no_channel is False)
            return
        for field, value in ast.iter_fields(node):
            if isinstance(value, list) and value \
                    and isinstance(value[0], ast.stmt):
                block(value, safe)
            elif isinstance(value, list):
                for c in value:
                    if isinstance(c, ast.AST):
                        visit(c, safe)
            elif isinstance(value, ast.AST):
                visit(value, safe)

    def block(stmts, safe: bool):
        for stmt in stmts:
            visit(stmt, safe)
            # `if ….channel is not None: return …` — the rest of the block
            # runs only without a mesh channel
            if isinstance(stmt, ast.If) and not stmt.orelse \
                    and _channel_test(stmt.test) is False and stmt.body \
                    and isinstance(stmt.body[-1], (ast.Return, ast.Raise)):
                safe = True

    visit(tree, False)


def _check_l005(tree, emit):
    scopes = [n for n in ast.walk(tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    owner: dict[int, str] = {}
    for fn in scopes:
        for node in ast.walk(fn):
            owner.setdefault(id(node), fn.name)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _dotted(node.func) != "object.__setattr__":
            continue
        scope = owner.get(id(node))
        if scope not in _SETATTR_OK_SCOPES:
            emit("L005", node,
                 f"object.__setattr__ in "
                 f"{scope or '<module>'} — frozen specs key the plan "
                 f"cache and must not mutate after __post_init__")


# -- drivers ----------------------------------------------------------------


def _rules_for(relpath: str) -> set[str]:
    p = pathlib.PurePosixPath(relpath)
    rules: set[str] = set()
    in_src = p.parts[:2] == ("src", _PACKAGE)
    if in_src or p.parts[:1] == ("benchmarks_torch",):
        rules.add("L001")
    if in_src:
        rules.update({"L003", "L005"})
        if "core" not in p.parts or "fft" not in p.parts:
            rules.add("L002")
    if relpath == _RUNTIME:
        rules.add("L004")
    return rules


def lint_file(path: pathlib.Path, root: pathlib.Path) -> list[LintFinding]:
    relpath = path.relative_to(root).as_posix()
    rules = _rules_for(relpath)
    if not rules:
        return []
    source = path.read_text()
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [LintFinding("L000", relpath, e.lineno or 0, "",
                            f"syntax error: {e.msg}")]
    aliases = _Aliases(tree)
    findings: list[LintFinding] = []

    def emit(rule, node, message):
        line = getattr(node, "lineno", 0)
        text = lines[line - 1] if 0 < line <= len(lines) else ""
        if _suppressed(rule, text):
            return
        findings.append(LintFinding(rule, relpath, line, text.strip(),
                                    message))

    if "L001" in rules:
        _check_l001(tree, aliases, emit)
    if "L002" in rules:
        _check_l002(tree, aliases, emit)
    if "L003" in rules:
        _check_l003(tree, emit)
    if "L004" in rules:
        _check_l004(tree, aliases, emit)
    if "L005" in rules:
        _check_l005(tree, emit)
    findings.sort(key=lambda f: (f.line, f.rule))
    return findings


def lint_tree(root: pathlib.Path | str | None = None) -> list[LintFinding]:
    """Lint every .py under src/repro_torch and benchmarks_torch of
    ``root`` (the repo checkout; defaults to the tree this module lives
    in)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[3]
    root = pathlib.Path(root)
    findings: list[LintFinding] = []
    for sub in _SCOPES:
        base = root / sub
        if not base.is_dir():
            continue
        for path in sorted(base.rglob("*.py")):
            findings.extend(lint_file(path, root))
    return findings


def load_baseline(path: pathlib.Path | str = BASELINE_PATH) -> set[str]:
    path = pathlib.Path(path)
    if not path.exists():
        return set()
    return {ln.strip() for ln in path.read_text().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")}


def save_baseline(findings, path: pathlib.Path | str = BASELINE_PATH):
    path = pathlib.Path(path)
    body = "\n".join(sorted({f.fingerprint for f in findings}))
    path.write_text(
        "# Grandfathered lint findings (RULE|path|stripped-line).\n"
        "# `python -m repro_torch.analysis` fails only on findings NOT\n"
        "# listed here. Shrink this file; never grow it.\n" + body + "\n")


def split_baseline(findings, baseline: set[str]):
    """-> (new, grandfathered) preserving order."""
    new = [f for f in findings if f.fingerprint not in baseline]
    old = [f for f in findings if f.fingerprint in baseline]
    return new, old
