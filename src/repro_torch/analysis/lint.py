"""hbcheck AST linter for the port: the protocol-safety rules behind
HummingBird's security argument, machine-checked over ``src/repro_torch``
(twin of the reference's ``analysis/lint.py``, recast for torch; the
intent of every rule is the reference's, the scopes are the port's
paths).

Rules (scoped to ``src/repro_torch``; tests are exempt where noted):

- **R001 raw-exchange** — wire primitives may only be called inside the
  comm seam: ``core/comm.py`` (the backends, ``MeshComm``'s process-group
  exchange and the coalescer), the round drivers ``core/gmw.py`` /
  ``core/gmw_ref.py``, the fault/journal layer ``core/faults.py``, the
  TCP framing ``transport/socket.py``, the per-party entry
  ``launch/party_host.py`` and the mesh ``launch/mesh.py`` (its
  ``gather`` of output blocks and device probe).  The primitives are the
  reference's methods (``.swap``/``.sendall``/``.recv``/``.recv_into``/
  ``.exchange``) and the ``torch.distributed`` point-to-point and
  collective calls (``isend``, ``irecv``, ``batch_isend_irecv``,
  ``send``, ``recv``, ``broadcast``, ``all_reduce``, ``reduce``,
  ``gather``, ``scatter``, ``all_gather*``, ``all_to_all*``,
  ``reduce_scatter*``), called or passed (``dist.P2POp(dist.isend, ...)``)
  on ``torch.distributed`` or a name imported from it.  Everything else
  goes through a ``Comm`` handed down from ``Session``, so rounds stay
  coalesced, counted, journaled and resumable.
- **R002 reveal-surface** — share recombination (``reveal``/
  ``reveal_np``/``to_uint64_np``) only inside ``api/``, ``serve/``,
  ``launch/`` and the defining core modules (``core/mpc_tensor.py``,
  ``core/ring.py``, ``core/shares.py``, ``core/fixed.py``).
- **R003 secret-branch** — no Python ``if``/``while``/ternary on a value
  derived from a share: an ``MPCTensor`` (annotated or constructed), or
  what ``share``/``encrypt``/``from_plain``/``xor_share_packed``/
  ``ring.from_limbs``/``ring.from_uint64_np`` return.  A method called on
  a share-derived tensor stays share-derived, so a host sync that
  branches on a share (``if x.sum().item():``, ``if bool(x.any()):``,
  ``int(...)``, ``.tolist()``) is flagged.  Metadata is public:
  ``.shape``, ``.dtype``, ``.device``, ``.numel()``, ``.dim()``,
  ``isinstance``, ``is None``.  Loop targets over ``zip``/``enumerate``
  take the taint of their own sequence, not of all of them.
- **R004 prng-discipline** — outside tests, no constant seed:
  ``prng.PRNGKey(<constant>)``, ``torch.manual_seed(<constant>)``,
  ``torch.Generator(...).manual_seed(<constant>)`` (any
  ``.manual_seed(<constant>)``).  In the protocol modules (``core/``,
  ``api/``, ``serve/``, ``transport/``, ``launch/``, ``runtime/``,
  ``kernels/``, ``nn/approx/``) also no draw from torch's global
  generator: ``torch.rand*``/``randn*``/``randint*``/``randperm``/
  ``bernoulli``/``normal``/``multinomial`` without ``generator=``, and the
  in-place ``.uniform_()``/``.normal_()``/``.random_()``/... without it.
  Torch has a global generator that JAX lacks; drawing from it makes a
  party's randomness depend on whatever ran before, not on the session.
- **R005 ring-dtype** — the ring modules (``core/ring.py``,
  ``ring_linalg.py``, ``gmw.py``, ``gmw_ref.py``, ``shares.py``) touch no
  float dtype: no ``torch.float*``/``half``/``bfloat16``/``double``, no
  ``.float()``/``.double()``/``.half()``, no ``dtype=float``, no
  ``"float32"`` strings, no true division (``/``, ``/=``,
  ``torch.true_divide``, ``torch.div`` without ``rounding_mode``).
  Shares live on Z/2^64 as int64; a float promotion silently destroys the
  ring.
- **R006 round-determinism** — modules on the round path (the
  reference's list mapped, plus ``core/prng.py``, which has no twin and
  draws every A2B mask and triple) use no ``time.time``/``time_ns``, no
  stdlib ``random``, no ``os.urandom``, and iterate over no set display
  or ``set(...)`` call.

Suppression: append ``# hbcheck: disable=R001`` (comma-separate several
rules, or ``disable=all``) to the offending line or the line above.
Grandfathered findings live in ``tools/hbcheck_torch_baseline.json``;
the CLI fails only on findings that are not in it.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# findings, suppressions, baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.  ``key()`` intentionally omits the line number
    so baseline entries survive unrelated edits above the finding."""

    file: str            # posix path relative to the scan root
    line: int
    rule: str
    message: str

    def key(self) -> Tuple[str, str, str]:
        return (self.file, self.rule, self.message)

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


_SUPPRESS_RE = re.compile(r"#\s*hbcheck:\s*disable=([A-Za-z0-9_,\s]+)")


def _suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def load_baseline(path) -> Set[Tuple[str, str, str]]:
    p = pathlib.Path(path)
    if not p.exists():
        return set()
    entries = json.loads(p.read_text())
    return {(e["file"], e["rule"], e["message"]) for e in entries}


def save_baseline(path, findings: Sequence[Finding]) -> None:
    entries = [{"file": f.file, "rule": f.rule, "message": f.message}
               for f in sorted(findings, key=lambda f: (f.file, f.rule))]
    pathlib.Path(path).write_text(json.dumps(entries, indent=1) + "\n")


# ---------------------------------------------------------------------------
# file context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FileCtx:
    path: str                  # normalized posix, relative to scan root
    tree: ast.Module
    lines: List[str]

    @property
    def mod(self) -> Optional[str]:
        """Path inside the ``repro_torch`` package ("core/gmw.py"), or None
        for files outside ``src/repro_torch`` (tests, tools, scripts...)."""
        marker = "src/repro_torch/"
        if marker in self.path:
            return self.path.split(marker, 1)[1]
        if self.path.startswith("repro_torch/"):
            return self.path[len("repro_torch/"):]
        return None

    @property
    def in_tests(self) -> bool:
        parts = pathlib.PurePosixPath(self.path).parts
        base = parts[-1] if parts else ""
        return ("tests" in parts or base.startswith("test_")
                or base == "conftest.py")


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------

def _call_name(func: ast.expr) -> str:
    """Terminal name of a call target: ``a.b.c(...)`` -> "c"."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name of an expression ("torch.distributed.isend")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _walk_calls(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _module_aliases(tree: ast.AST, module: str) -> Set[str]:
    """Names bound to ``module`` by this file's imports, plus the dotted
    module path itself ("torch.distributed", "dist")."""
    out = {module}
    parent, _, leaf = module.rpartition(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module and a.asname:
                    out.add(a.asname)
                elif a.name == module.split(".")[0] and a.asname is None:
                    out.add(module)
        elif isinstance(node, ast.ImportFrom) and parent \
                and node.module == parent and node.level == 0:
            for a in node.names:
                if a.name == leaf:
                    out.add(a.asname or a.name)
    return out


def _names_from(tree: ast.AST, module: str) -> Dict[str, str]:
    """Local name -> original name of everything ``from module import``s."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module \
                and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


# ---------------------------------------------------------------------------
# R001 — raw exchange outside the comm seam
# ---------------------------------------------------------------------------

R001_SEAM = frozenset({
    "core/comm.py", "core/gmw.py", "core/gmw_ref.py", "core/faults.py",
    "transport/socket.py", "launch/party_host.py", "launch/mesh.py",
})
_R001_METHODS = frozenset({"swap", "sendall", "recv", "recv_into",
                           "exchange"})
_DIST_PRIMITIVES = frozenset({"isend", "irecv", "batch_isend_irecv", "send",
                              "recv", "broadcast", "all_reduce", "reduce",
                              "gather", "scatter"})
_DIST_PREFIXES = ("all_gather", "all_to_all", "reduce_scatter")


def _is_dist_primitive(name: str) -> bool:
    return name in _DIST_PRIMITIVES or name.startswith(_DIST_PREFIXES)


def _dist_uses(ctx: FileCtx):
    """(node, name) of every ``torch.distributed`` primitive this file
    calls or passes on, through the module or a name imported from it."""
    aliases = _module_aliases(ctx.tree, "torch.distributed")
    imported = {local: orig for local, orig in
                _names_from(ctx.tree, "torch.distributed").items()
                if _is_dist_primitive(orig)}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and _is_dist_primitive(node.attr) \
                and _dotted(node.value) in aliases:
            yield node, node.attr
        elif isinstance(node, ast.Name) and node.id in imported \
                and isinstance(node.ctx, ast.Load):
            yield node, imported[node.id]


def rule_r001(ctx: FileCtx) -> List[Finding]:
    if ctx.mod is None or ctx.mod in R001_SEAM or ctx.in_tests:
        return []
    seam = ", ".join(sorted(R001_SEAM))
    uses = list(_dist_uses(ctx))
    dist_nodes = {id(node) for node, _ in uses}
    out = []
    for call in _walk_calls(ctx.tree):
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _R001_METHODS \
                and id(call.func) not in dist_nodes:
            out.append(Finding(
                ctx.path, call.lineno, "R001",
                f"raw wire primitive .{call.func.attr}() outside the comm "
                f"seam ({seam}); route exchanges through a Session-provided "
                f"Comm"))
    for node, name in uses:
        out.append(Finding(
            ctx.path, node.lineno, "R001",
            f"torch.distributed.{name} outside the comm seam ({seam}); "
            f"route exchanges through a Session-provided Comm"))
    return out


# ---------------------------------------------------------------------------
# R002 — reveal / share recombination outside the approved surface
# ---------------------------------------------------------------------------

R002_SURFACE_PREFIXES = ("api/", "serve/", "launch/")
R002_SURFACE_FILES = frozenset({
    "core/mpc_tensor.py", "core/ring.py", "core/shares.py", "core/fixed.py",
})
_R002_NAMES = frozenset({"reveal", "reveal_np", "to_uint64_np"})


def rule_r002(ctx: FileCtx) -> List[Finding]:
    mod = ctx.mod
    if (mod is None or ctx.in_tests or mod in R002_SURFACE_FILES
            or mod.startswith(R002_SURFACE_PREFIXES)):
        return []
    out = []
    for call in _walk_calls(ctx.tree):
        name = _call_name(call.func)
        if name in _R002_NAMES:
            out.append(Finding(
                ctx.path, call.lineno, "R002",
                f"share recombination {name}() outside the approved "
                f"reveal surface (api/, serve/, launch/, core share types)"))
    return out


# ---------------------------------------------------------------------------
# R003 — secret-dependent Python control flow
# ---------------------------------------------------------------------------

_TAINT_CONSTRUCTORS = frozenset({"MPCTensor", "share", "encrypt", "from_plain",
                                 "xor_share_packed", "from_limbs",
                                 "from_uint64_np"})
_TAINT_ANNOTATIONS = frozenset({"MPCTensor"})
# public metadata on share-typed values: branching on these is fine
_DECLASSIFIED_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "nbytes",
                                 "frac_bits", "out_batch", "n_elements",
                                 "width", "group", "device", "is_cuda",
                                 "layout", "itemsize"})
_DECLASSIFY_CALLS = frozenset({"reveal", "reveal_np", "len", "isinstance",
                               "type", "id", "repr", "str", "prod", "hash"})
# tensor methods that read metadata only
_DECLASSIFY_METHODS = frozenset({"numel", "nelement", "dim", "ndimension",
                                 "size", "element_size", "stride",
                                 "get_device", "is_contiguous",
                                 "is_floating_point"})


class _SecretFlow(ast.NodeVisitor):
    """Per-scope forward taint: share-typed names may not feed
    if/while/ternary tests.  Scope-local and syntactic on purpose: a lint
    heuristic, not an information-flow proof (the leakage census in
    ``analysis/census.py`` checks what actually goes on the wire)."""

    def __init__(self, ctx: FileCtx, findings: List[Finding]):
        self.ctx = ctx
        self.findings = findings
        self.tainted: Set[str] = set()

    # -- taint query --------------------------------------------------------
    def _is_tainted(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _DECLASSIFIED_ATTRS:
                return False
            return self._is_tainted(e.value)
        if isinstance(e, (ast.Subscript, ast.Starred)):
            return self._is_tainted(e.value)
        if isinstance(e, ast.Call):
            name = _call_name(e.func)
            if name in _DECLASSIFY_CALLS:
                return False
            if name in _TAINT_CONSTRUCTORS:
                return True
            if isinstance(e.func, ast.Attribute):
                if name in _DECLASSIFY_METHODS:
                    return False
                # x.sum().item(), x.any(), x.tolist(): the receiver's taint
                if self._is_tainted(e.func.value):
                    return True
            args = list(e.args) + [kw.value for kw in e.keywords]
            return any(self._is_tainted(a) for a in args)
        if isinstance(e, ast.BinOp):
            return self._is_tainted(e.left) or self._is_tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self._is_tainted(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self._is_tainted(v) for v in e.values)
        if isinstance(e, ast.Compare):
            # identity tests against None are public (optional-arg idiom)
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops) \
                    and all(isinstance(c, ast.Constant)
                            for c in e.comparators):
                return False
            return (self._is_tainted(e.left)
                    or any(self._is_tainted(c) for c in e.comparators))
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(self._is_tainted(el) for el in e.elts)
        if isinstance(e, ast.IfExp):
            return (self._is_tainted(e.body) or self._is_tainted(e.orelse))
        return False

    # -- taint updates ------------------------------------------------------
    def _taint_target(self, target: ast.expr, value_tainted: bool):
        if isinstance(target, ast.Name):
            if value_tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el, value_tainted)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value, value_tainted)

    def _taint_loop_target(self, target: ast.expr, it: ast.expr):
        """A loop target takes its own sequence's taint: ``for i, (a, b) in
        enumerate(zip(xs, ys))`` gives ``i`` none, ``a`` xs' and ``b`` ys'."""
        if isinstance(target, (ast.Tuple, ast.List)) \
                and isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and not it.keywords:
            if it.func.id == "zip" and len(target.elts) == len(it.args) \
                    and not any(isinstance(a, ast.Starred) for a in it.args):
                for tgt, seq in zip(target.elts, it.args):
                    self._taint_loop_target(tgt, seq)
                return
            if it.func.id == "enumerate" and len(target.elts) == 2 \
                    and len(it.args) == 1:
                self._taint_target(target.elts[0], False)
                self._taint_loop_target(target.elts[1], it.args[0])
                return
        self._taint_target(target, self._is_tainted(it))

    def visit_Assign(self, node: ast.Assign):
        t = self._is_tainted(node.value)
        if (isinstance(node.value, (ast.Tuple, ast.List))
                and len(node.targets) == 1
                and isinstance(node.targets[0], (ast.Tuple, ast.List))
                and len(node.targets[0].elts) == len(node.value.elts)):
            for tgt, val in zip(node.targets[0].elts, node.value.elts):
                self._taint_target(tgt, self._is_tainted(val))
        else:
            for tgt in node.targets:
                self._taint_target(tgt, t)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        ann_taint = any(isinstance(n, ast.Name) and n.id in _TAINT_ANNOTATIONS
                        for n in ast.walk(node.annotation))
        t = ann_taint or (node.value is not None
                          and self._is_tainted(node.value))
        self._taint_target(node.target, t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        if self._is_tainted(node.value):
            self._taint_target(node.target, True)
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        self._taint_loop_target(node.target, node.iter)
        self.generic_visit(node)

    # -- scopes -------------------------------------------------------------
    def _enter_function(self, node):
        sub = _SecretFlow(self.ctx, self.findings)
        args = list(node.args.args) + list(node.args.posonlyargs) \
            + list(node.args.kwonlyargs)
        for a in args:
            if a.annotation is not None and any(
                    isinstance(n, ast.Name) and n.id in _TAINT_ANNOTATIONS
                    for n in ast.walk(a.annotation)):
                sub.tainted.add(a.arg)
        for stmt in node.body:
            sub.visit(stmt)

    def visit_FunctionDef(self, node):
        self._enter_function(node)

    def visit_AsyncFunctionDef(self, node):
        self._enter_function(node)

    # -- the actual rule ----------------------------------------------------
    def _flag(self, node, what: str):
        self.findings.append(Finding(
            self.ctx.path, node.lineno, "R003",
            f"secret-dependent {what}: the condition derives from an "
            f"MPCTensor share (control flow is observable; reveal "
            f"explicitly or use arithmetic select)"))

    def visit_If(self, node: ast.If):
        if self._is_tainted(node.test):
            self._flag(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        if self._is_tainted(node.test):
            self._flag(node, "while")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp):
        if self._is_tainted(node.test):
            self._flag(node, "ternary")
        self.generic_visit(node)


def rule_r003(ctx: FileCtx) -> List[Finding]:
    if ctx.mod is None or ctx.in_tests:
        return []
    findings: List[Finding] = []
    flow = _SecretFlow(ctx, findings)
    for stmt in ctx.tree.body:
        flow.visit(stmt)
    return findings


# ---------------------------------------------------------------------------
# R004 — PRNG discipline
# ---------------------------------------------------------------------------

R004_PROTOCOL_PREFIXES = ("core/", "api/", "serve/", "transport/", "launch/",
                          "runtime/", "kernels/", "nn/approx/")
_GLOBAL_DRAWS = frozenset({"rand", "rand_like", "randn", "randn_like",
                           "randint", "randint_like", "randperm", "bernoulli",
                           "normal", "multinomial", "poisson"})
_INPLACE_DRAWS = frozenset({"uniform_", "normal_", "random_", "bernoulli_",
                            "exponential_", "geometric_", "cauchy_",
                            "log_normal_"})


def rule_r004(ctx: FileCtx) -> List[Finding]:
    if ctx.mod is None or ctx.in_tests:
        return []
    out = []
    for call in _walk_calls(ctx.tree):
        name = _call_name(call.func)
        if name in ("PRNGKey", "manual_seed") and call.args \
                and isinstance(call.args[0], ast.Constant):
            out.append(Finding(
                ctx.path, call.lineno, "R004",
                f"constant PRNG seed {name}({call.args[0].value!r}); derive "
                f"keys from Session (next_key/request_key) or a "
                f"caller-provided seed"))
    if not ctx.mod.startswith(R004_PROTOCOL_PREFIXES):
        return out
    torch_names = _module_aliases(ctx.tree, "torch")
    imported = {local for local, orig in _names_from(ctx.tree, "torch").items()
                if orig in _GLOBAL_DRAWS}
    for call in _walk_calls(ctx.tree):
        if _has_kw(call, "generator"):
            continue
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _GLOBAL_DRAWS \
                and _dotted(f.value) in torch_names:
            what = f"torch.{f.attr}()"
        elif isinstance(f, ast.Name) and f.id in imported:
            what = f"torch.{f.id}()"
        elif isinstance(f, ast.Attribute) and f.attr in _INPLACE_DRAWS:
            what = f".{f.attr}()"
        else:
            continue
        out.append(Finding(
            ctx.path, call.lineno, "R004",
            f"{what} draws from torch's global generator in a protocol "
            f"module; derive randomness from the session's keys "
            f"(core/prng.py) or pass generator="))
    return out


# ---------------------------------------------------------------------------
# R005 — ring dtype discipline in core/
# ---------------------------------------------------------------------------

R005_RING_MODULES = frozenset({
    "core/ring.py", "core/ring_linalg.py", "core/gmw.py", "core/gmw_ref.py",
    "core/shares.py",
})
_FLOAT_NAMES = frozenset({"float", "float32", "float64", "float16", "bfloat16",
                          "float_", "double", "half"})
_FLOAT_STRINGS = frozenset({"float32", "float64", "float16", "bfloat16"})
_RING = ("(shares live on Z/2^64 as int64; float promotion breaks the "
         "ring)")


def rule_r005(ctx: FileCtx) -> List[Finding]:
    if ctx.mod not in R005_RING_MODULES:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and node.attr in _FLOAT_NAMES:
            out.append(Finding(
                ctx.path, node.lineno, "R005",
                f"float dtype {_dotted(node)} in a ring module {_RING}"))
        elif isinstance(node, ast.Constant) and node.value in _FLOAT_STRINGS:
            out.append(Finding(
                ctx.path, node.lineno, "R005",
                f"float dtype string {node.value!r} in a ring module"))
        elif isinstance(node, ast.keyword) and node.arg == "dtype" \
                and isinstance(node.value, ast.Name) \
                and node.value.id in ("float", "complex"):
            out.append(Finding(
                ctx.path, node.value.lineno, "R005",
                f"dtype={node.value.id} in a ring module {_RING}"))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if isinstance(node.left, ast.Constant) and \
                    isinstance(node.right, ast.Constant):
                continue            # pure scalar constant math is fine
            out.append(Finding(
                ctx.path, node.lineno, "R005",
                "true division in a ring module promotes to float; use "
                "// or shifts on the int64 ring values"))
        elif isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Div):
            out.append(Finding(
                ctx.path, node.lineno, "R005",
                "true division in a ring module promotes to float; use "
                "// or shifts on the int64 ring values"))
        elif isinstance(node, ast.Call) and (
                _call_name(node.func) == "true_divide"
                or (_call_name(node.func) in ("div", "divide")
                    and not _has_kw(node, "rounding_mode"))):
            out.append(Finding(
                ctx.path, node.lineno, "R005",
                f"{_call_name(node.func)}() without rounding_mode in a ring "
                f"module is true division; use // or shifts"))
    return out


# ---------------------------------------------------------------------------
# R006 — determinism on the round path
# ---------------------------------------------------------------------------

R006_ROUND_PATH = frozenset({
    "core/gmw.py", "core/gmw_ref.py", "core/schedule.py", "core/comm.py",
    "core/faults.py", "core/beaver.py", "core/costmodel.py",
    "transport/socket.py", "transport/engine_link.py",
    # the reduced-ring nonlinearity subsystem drives relu_fn / Beaver-open
    # placement, so its evaluation order feeds the schedule directly
    "nn/approx/__init__.py", "nn/approx/pwl.py", "nn/approx/attention.py",
    "nn/approx/bounds.py",
    # the port's threefry (no twin: the reference takes jax.random) draws
    # every A2B mask and every triple of every round
    "core/prng.py",
})


def rule_r006(ctx: FileCtx) -> List[Finding]:
    if ctx.mod not in R006_ROUND_PATH:
        return []
    imports_stdlib_random = any(
        (isinstance(n, ast.Import)
         and any(a.name == "random" for a in n.names))
        or (isinstance(n, ast.ImportFrom) and n.module == "random")
        for n in ast.walk(ctx.tree))
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted in ("time.time", "time.time_ns"):
                out.append(Finding(
                    ctx.path, node.lineno, "R006",
                    f"wall clock {dotted}() on the round path; rounds must "
                    f"replay deterministically (time.monotonic is fine for "
                    f"intervals)"))
            elif dotted == "os.urandom":
                out.append(Finding(
                    ctx.path, node.lineno, "R006",
                    "os.urandom on the round path; randomness must come "
                    "from session-derived PRNG keys"))
            elif imports_stdlib_random and dotted.startswith("random."):
                out.append(Finding(
                    ctx.path, node.lineno, "R006",
                    f"stdlib {dotted}() on the round path; use "
                    f"session-derived PRNG keys"))
        elif isinstance(node, (ast.For, ast.comprehension)):
            it = node.iter
            if isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call)
                    and _call_name(it.func) == "set"):
                out.append(Finding(
                    ctx.path, getattr(node, "lineno", it.lineno), "R006",
                    "iteration over an unordered set on the round path; "
                    "sort it (set order must not feed the schedule)"))
    return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

RULES: Tuple[Tuple[str, Callable[[FileCtx], List[Finding]]], ...] = (
    ("R001", rule_r001), ("R002", rule_r002), ("R003", rule_r003),
    ("R004", rule_r004), ("R005", rule_r005), ("R006", rule_r006),
)


def lint_source(source: str, path: str) -> List[Finding]:
    """Lint one file's source text; ``path`` drives rule scoping (use the
    repo-relative posix path, e.g. "src/repro_torch/core/gmw.py")."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "R000",
                        f"syntax error: {e.msg}")]
    lines = source.splitlines()
    ctx = FileCtx(path=path, tree=tree, lines=lines)
    findings: List[Finding] = []
    for _, rule in RULES:
        findings.extend(rule(ctx))
    sup = _suppressions(lines)
    kept = []
    for f in findings:
        rules_here = sup.get(f.line, set()) | sup.get(f.line - 1, set())
        if f.rule in rules_here or "all" in rules_here:
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    return kept


def lint_paths(paths: Sequence, root=None) -> List[Finding]:
    """Lint every ``*.py`` under ``paths`` (files or directories).
    Reported paths are posix-relative to ``root`` (default: cwd)."""
    root = pathlib.Path(root or ".").resolve()
    findings: List[Finding] = []
    for p in paths:
        p = pathlib.Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            try:
                rel = f.resolve().relative_to(root).as_posix()
            except ValueError:
                rel = f.as_posix()
            findings.extend(lint_source(f.read_text(), rel))
    return findings
