"""Lock-discipline checker for the port's serving engine and frontend
(twin of the reference's ``analysis/locks.py``; same semantics).

``serve.InferenceEngine`` runs a background pump thread (``_pump_loop``)
next to caller threads (``submit``/``poll``/``flush``/``stats``/HTTP
executor threads), all serialized by one ``RLock`` (``self._lock``), which
in the port is also the device lock (``device_lock``): every device
operation of the serving process runs under it.  The invariant: every
access to pump-shared mutable attributes happens under that lock.  This
module checks it statically:

- an access is *guarded* if it sits lexically inside ``with self._lock:``
  (the RLock makes nesting safe), or
- it sits in a private helper (``_name``) whose **every** intra-class
  call site is itself guarded (computed to a fixpoint), or
- it sits in ``__init__`` (no other thread can hold the instance yet).

Nested ``def``/``lambda`` bodies are deliberately treated as unguarded
even when defined under the lock: they may run later, on another thread,
after the lock is released.

For ``serve.Frontend`` (single asyncio loop, no lock of its own) the
check is different: the frontend must reach engine state only through
the engine's public, self-locking API; any ``self.engine._private``
access bypasses the engine's lock and is flagged.

Findings use rule ids L001 (unguarded attribute access) and L002
(private cross-object reach), reported through the same ``Finding``
type and baseline as the AST linter.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, List, Sequence, Set, Tuple

from .lint import Finding

# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockSpec:
    """What to check in one class: which attribute is the lock, and which
    attributes it guards."""

    class_name: str
    lock_attr: str = "_lock"
    guarded: frozenset = frozenset()
    exempt_methods: Tuple[str, ...] = ("__init__",)


# the pump-shared mutable state of the port's serve/engine.py: queue +
# futures + id admission, plan cache, tenant providers, report and total
# accumulators, the pump error mirror (the reference's set), plus the
# straggler watchdog every batch feeds and ``stats`` reads, and the
# coalescing comm whose counters every batch advances on the device path
ENGINE_SPEC = LockSpec(
    class_name="InferenceEngine",
    lock_attr="_lock",
    guarded=frozenset({
        "_queue", "_futures", "_used_ids", "_next_id", "_plan_cache",
        "_tenants", "_totals", "reports", "last_pump_error",
        "watchdog", "comm",
    }),
)

DEFAULT_SPECS: Tuple[LockSpec, ...] = (ENGINE_SPEC,)


# ---------------------------------------------------------------------------
# per-method scan
# ---------------------------------------------------------------------------

def _is_self_attr(node: ast.expr, attr: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


class _MethodScan(ast.NodeVisitor):
    """Collect guarded-attribute accesses and intra-class call sites of
    one method, each tagged with whether the lock is lexically held."""

    def __init__(self, spec: LockSpec):
        self.spec = spec
        self.depth = 0
        self.accesses: List[Tuple[str, int, bool]] = []   # attr, line, locked
        self.calls: List[Tuple[str, bool]] = []           # method, locked

    def visit_With(self, node: ast.With):
        holds = any(_is_self_attr(item.context_expr, self.spec.lock_attr)
                    for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if holds:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and node.attr in self.spec.guarded:
            self.accesses.append((node.attr, node.lineno, self.depth > 0))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            self.calls.append((node.func.attr, self.depth > 0))
        self.generic_visit(node)

    # deferred bodies: the lock may be long gone when these run
    def _deferred(self, node):
        saved = self.depth
        self.depth = 0
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.depth = saved

    def visit_FunctionDef(self, node):
        self._deferred(node)

    def visit_AsyncFunctionDef(self, node):
        self._deferred(node)

    def visit_Lambda(self, node):
        self._deferred(node)


def check_lock_discipline(source: str, path: str,
                          specs: Sequence[LockSpec] = DEFAULT_SPECS,
                          ) -> List[Finding]:
    """Check every configured class found in ``source``."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "L000",
                        f"syntax error: {e.msg}")]
    by_name = {s.class_name: s for s in specs}
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in by_name:
            findings.extend(_check_class(node, by_name[node.name], path))
    findings.sort(key=lambda f: (f.file, f.line))
    return findings


def _check_class(cls: ast.ClassDef, spec: LockSpec,
                 path: str) -> List[Finding]:
    scans: Dict[str, _MethodScan] = {}
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _MethodScan(spec)
            for child in stmt.body:
                scan.visit(child)
            scans[stmt.name] = scan

    # fixpoint: private helpers whose every call site holds the lock are
    # themselves lock-held (public methods are externally callable, so
    # only _-prefixed names qualify; a helper with no in-class call site
    # has unknown callers, e.g. a Thread target, and stays unguarded)
    call_sites: Dict[str, List[Tuple[str, bool]]] = {}
    for caller, scan in scans.items():
        for callee, locked in scan.calls:
            call_sites.setdefault(callee, []).append((caller, locked))
    held: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name in scans:
            if name in held or not name.startswith("_") \
                    or name in spec.exempt_methods:
                continue
            sites = call_sites.get(name)
            if sites and all(locked or caller in held
                             for caller, locked in sites):
                held.add(name)
                changed = True

    out: List[Finding] = []
    for name, scan in scans.items():
        if name in spec.exempt_methods or name in held:
            continue
        for attr, line, locked in scan.accesses:
            if not locked:
                out.append(Finding(
                    path, line, "L001",
                    f"{spec.class_name}.{name} touches pump-shared "
                    f"self.{attr} without holding self.{spec.lock_attr}"))
    return out


# ---------------------------------------------------------------------------
# cross-object private reach (Frontend -> engine internals)
# ---------------------------------------------------------------------------

def check_private_reach(source: str, path: str,
                        owner_attrs: Sequence[str] = ("engine",),
                        ) -> List[Finding]:
    """Flag ``self.<owner>._private`` chains: reaching into another
    object's underscore state bypasses that object's lock."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "L000",
                        f"syntax error: {e.msg}")]
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr.startswith("_") \
                and not node.attr.startswith("__"):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr in owner_attrs \
                    and isinstance(v.value, ast.Name) and v.value.id == "self":
                out.append(Finding(
                    path, node.lineno, "L002",
                    f"private reach self.{v.attr}.{node.attr} bypasses "
                    f"{v.attr}'s own locking; use its public API"))
    out.sort(key=lambda f: (f.file, f.line))
    return out


def check_paths(root=None) -> List[Finding]:
    """Run both checks on the port's serving modules under ``root`` (repo
    root or any directory containing ``src/repro_torch/serve``)."""
    root = pathlib.Path(root or ".")
    serve = root / "src" / "repro_torch" / "serve"
    if not serve.exists():                      # installed-package layout
        serve = root / "repro_torch" / "serve"
    findings: List[Finding] = []
    eng = serve / "engine.py"
    fr = serve / "frontend.py"
    if eng.exists():
        findings.extend(check_lock_discipline(
            eng.read_text(), f"src/repro_torch/serve/{eng.name}"))
    if fr.exists():
        findings.extend(check_private_reach(
            fr.read_text(), f"src/repro_torch/serve/{fr.name}"))
    return findings
