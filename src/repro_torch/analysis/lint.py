"""repro-lint of the port — stdlib-``ast`` checks for the repo's unchecked
invariants (a port of ``repro.analysis.lint``, which the port does not
import: it keeps its own copy, with torch's host syncs added).

Five named rules, as in the reference:

* ``lease-pairing`` — every acquire-side lease call is paired with its
  release-side twin on the same receiver in the same function:
  ``<recv>.acquire(...)``/``<recv>.release(...)`` (param slots, staging
  rings, shm views) and ``<recv>.allocate(...)``|``<recv>.alloc(...)``/
  ``<recv>.free(...)`` (the serving plane's cache slots). When the
  release happens in this function's own control flow it must sit under
  a ``try/finally`` so error paths cannot leak the lease (a leaked lease
  deadlocks the learner's ``reserve`` or starves the ring/slot pool). A
  release inside a nested ``lambda``/``def`` is the *deferred handoff*
  idiom (the payload's ``release``/``free`` callback) and satisfies the
  rule. ``reserve`` must likewise pair with ``commit`` (no finally
  needed: reserve only waits, it holds nothing on failure).
* ``span-pairing`` — every ``SpanEmitter.begin`` is balanced by ``end()``
  or ``cancel()`` on every early-return path and on normal completion
  (an unbalanced span corrupts the emitter's open-span stack and every
  later total). Checked by abstract interpretation over the function
  body tracking per-receiver open-span depth through if/while/for/try;
  exceptional exits are exempt (an uncaught exception tears the whole
  track down and ``reset()`` re-zeroes it).
* ``donated-reuse`` — a variable passed in a donated argument position of
  a known fused call (any name assigned from ``jax.jit(...,
  donate_argnums=...)`` in the same module) must not be read again before
  being reassigned. Torch has no donation, so the rule finds nothing in
  the port; it stays so that this linter reads either package.
* ``hot-path-sync`` — no host syncs inside functions marked with a
  ``# hot-path`` comment (on or directly above the ``def``) or on the
  built-in allowlist (the span-emitter hot path): ``float()``/``int()``/
  ``bool()`` on non-constants, ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize``, a stream's
  or an event's), ``np.asarray``/``np.array`` and ``jax.device_get``.
  ``.cpu()`` and ``.numpy()`` are flagged whatever the tensor's device:
  the linter cannot know it, and a hot path that means a host copy says
  so with a suppression.
* ``hostenv-picklable`` — ``HostEnvSpec(...)`` must be constructed from a
  module-level callable: a lambda or locally-defined ``env_fn`` dies at
  pickling time inside a spawned worker, far from the author.

Suppression: append ``# repro-lint: disable=<rule>[,<rule>...]`` to the
offending line, or to the ``def`` line to waive a whole function (the
reference's marker, so one comment serves both linters).

Run as ``python -m repro_torch.analysis.lint [paths...]`` (default
``src/repro_torch``); exit 0 clean, 1 with findings, 2 on usage errors.
Pure stdlib — no new dependencies.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "RULES", "lint_paths", "lint_source", "main"]

RULES: Dict[str, str] = {
    "lease-pairing": "acquire/release, allocate/free (and reserve/commit) "
                     "pairing under try/finally on all paths",
    "span-pairing": "SpanEmitter.begin balanced by end() or cancel() on "
                    "every non-exceptional path",
    "donated-reuse": "no use of a variable after it rode a donated "
                     "argument position of a fused jitted call",
    "hot-path-sync": "no host syncs inside # hot-path functions",
    "hostenv-picklable": "HostEnvSpec built from module-level callables "
                         "only (spawned workers unpickle the recipe)",
}

# lease verbs: acquire-side name -> its matching release-side name.
# acquire/release is the pipeline ring's vocabulary; allocate|alloc/free
# is the serving slot cache's (KVSlotCache). Same rule, same deferred-
# handoff and try/finally semantics for every pair.
_LEASE_PAIRS = {"acquire": "release", "allocate": "free", "alloc": "free"}
_LEASE_ACQ = set(_LEASE_PAIRS)
_LEASE_REL = set(_LEASE_PAIRS.values())

# function names that ARE the lease protocol implementation (their bodies
# legitimately touch one side of a pair)
_LEASE_IMPL = {
    "acquire", "release", "reserve", "commit", "publish", "revoke",
    "read", "__enter__", "__exit__",
    "allocate", "alloc", "free", "evict",
}

# hot by construction, no comment marker needed (the rule's allowlist arm)
HOT_PATH_QUALNAMES = {
    "SpanEmitter.begin", "SpanEmitter.end", "SpanEmitter.cancel",
    "SpanEmitter.record", "SpanEmitter._record",
}

_SYNC_CALLS = {"float", "int", "bool"}
_SYNC_DOTTED = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "jax.device_get",
}
# torch's host syncs by method: a scalar or list read, a copy to host
# memory, and a wait on the card (torch.cuda, a stream or an event)
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w,\- ]+)")
_HOT_RE = re.compile(r"#\s*hot-path\b")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'self._slot' for Attribute chains over Names; None otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _attr_call(node: ast.AST, attrs: Set[str]) -> Optional[Tuple[str, str]]:
    """(receiver, attr) when node is a ``<recv>.<attr>(...)`` call with
    attr in ``attrs`` and a resolvable dotted receiver."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in attrs):
        recv = _dotted(node.func.value)
        if recv is not None:
            return recv, node.func.attr
    return None


def _direct_statements(func: ast.AST):
    """Every statement in ``func``'s own body, not descending into nested
    function/class definitions (those run at other times)."""
    todo = list(func.body)
    while todo:
        stmt = todo.pop(0)
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            todo.extend(getattr(stmt, field, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            todo.extend(h.body)


def _direct_expr_walk(stmt: ast.stmt):
    """Walk a statement's expressions without entering nested defs or
    lambdas (their bodies execute later, under different pairing)."""
    todo = [stmt]
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(node))


class _FileLint:
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.findings: List[Finding] = []
        # line -> suppressed rule names
        self.suppress: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppress[i] = {r.strip()
                                    for r in m.group(1).split(",") if r.strip()}
        # (func node, qualname, enclosing-function chain)
        self.functions: List[Tuple[ast.AST, str, int]] = []
        self._collect_functions(self.tree, prefix="", depth=0)

    def _collect_functions(self, node: ast.AST, prefix: str, depth: int):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self.functions.append((child, qual, depth))
                self._collect_functions(child, f"{qual}.", depth + 1)
            elif isinstance(child, ast.ClassDef):
                self._collect_functions(child, f"{child.name}.", depth)
            else:
                self._collect_functions(child, prefix, depth)

    def _suppressed(self, rule: str, line: int, func: ast.AST = None) -> bool:
        if rule in self.suppress.get(line, ()):
            return True
        if func is not None and rule in self.suppress.get(func.lineno, ()):
            return True
        return False

    def emit(self, rule: str, node: ast.AST, message: str,
             func: ast.AST = None) -> None:
        line = getattr(node, "lineno", 1)
        if not self._suppressed(rule, line, func):
            f = Finding(self.path, line, rule, message)
            if f not in self.findings:
                self.findings.append(f)

    def run(self) -> List[Finding]:
        donated = self._donation_registry()
        for func, qual, _depth in self.functions:
            self._check_leases(func, qual)
            self._check_spans(func)
            self._check_donated(func, donated)
            self._check_hot_path(func, qual)
        self._check_hostenv()
        return self.findings

    # -- rule: lease-pairing -------------------------------------------------
    def _check_leases(self, func: ast.AST, qual: str) -> None:
        name = qual.rsplit(".", 1)[-1]
        if name in _LEASE_IMPL:
            return
        in_finally: Set[int] = set()
        for stmt in _direct_statements(func):
            if isinstance(stmt, ast.Try):
                for fstmt in stmt.finalbody:
                    for sub in ast.walk(fstmt):
                        in_finally.add(id(sub))
        # acquire-side calls keyed by (recv, acquire-verb); a release-side
        # call matches when its recv and verb agree with _LEASE_PAIRS
        acquires: Dict[Tuple[str, str], ast.Call] = {}
        reserves: Dict[str, ast.Call] = {}
        direct_rel: Dict[Tuple[str, str], List[bool]] = {}  # in_finally?
        commits: Set[str] = set()
        deferred_rel: Set[Tuple[str, str]] = set()
        verbs = _LEASE_ACQ | _LEASE_REL | {"reserve", "commit"}
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                hit = _attr_call(node, verbs)
                if hit is None:
                    continue
                recv, attr = hit
                if attr in _LEASE_ACQ:
                    acquires.setdefault((recv, attr), node)
                elif attr == "reserve":
                    reserves.setdefault(recv, node)
                elif attr in _LEASE_REL:
                    direct_rel.setdefault((recv, attr), []).append(
                        id(node) in in_finally)
                elif attr == "commit":
                    commits.add(recv)
        # releases handed off into nested lambdas/defs (payload callbacks)
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                if isinstance(node, (ast.Lambda, ast.FunctionDef)):
                    for sub in ast.walk(node):
                        hit = _attr_call(sub, _LEASE_REL)
                        if hit is not None:
                            deferred_rel.add(hit)
        for (recv, acq), call in acquires.items():
            rel = _LEASE_PAIRS[acq]
            rels = direct_rel.get((recv, rel), [])
            if not rels and (recv, rel) not in deferred_rel:
                self.emit(
                    "lease-pairing", call,
                    f"{recv}.{acq}() has no matching {recv}.{rel}() in "
                    "this function — a leaked lease starves the ring or "
                    "slot pool and deadlocks upstream admission", func)
            elif rels and not any(rels):
                self.emit(
                    "lease-pairing", call,
                    f"{recv}.{rel}() is not under try/finally — an "
                    f"exception between {acq} and {rel} leaks the "
                    "lease", func)
        for recv, call in reserves.items():
            if recv not in commits:
                self.emit(
                    "lease-pairing", call,
                    f"{recv}.reserve() without {recv}.commit() in this "
                    "function — the reserved buffer never publishes and "
                    "readers wait on a version that never lands", func)

    # -- rule: span-pairing --------------------------------------------------
    def _check_spans(self, func: ast.AST) -> None:
        recvs: List[str] = []
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                hit = _attr_call(node, {"begin"})
                if hit is not None and hit[0] not in recvs:
                    recvs.append(hit[0])
        if not recvs:
            return
        idx = {r: i for i, r in enumerate(recvs)}
        # a state is (per-receiver open-span depths, tainted): tainted
        # states descend from an exception-handler entry — exceptional
        # paths, which this rule forgives — and are simulated only so
        # handler-side cancel()/reset() keep downstream states accurate
        zero = ((0,) * len(recvs), False)

        def apply_stmt(stmt: ast.stmt, state) -> tuple:
            depths, tainted = list(state[0]), state[1]
            for node in _direct_expr_walk(stmt):
                hit = _attr_call(node, {"begin", "end", "cancel", "reset"})
                if hit is None or hit[0] not in idx:
                    continue
                r, attr = hit
                if attr == "begin":
                    depths[idx[r]] += 1
                elif attr == "reset":
                    depths[idx[r]] = 0
                else:
                    depths[idx[r]] = max(depths[idx[r]] - 1, 0)
            return tuple(depths), tainted

        returns: List[Tuple[ast.stmt, tuple]] = []
        loop_bad: List[ast.stmt] = []

        def untainted(states):
            return {s for s in states if not s[1]}

        def exec_block(stmts, states):
            """-> (normal, breaks, continues, during); returns accumulate."""
            cur = set(states)
            breaks: Set[tuple] = set()
            continues: Set[tuple] = set()
            during: Set[tuple] = set(cur)
            for stmt in stmts:
                if not cur:
                    break
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.Return):
                    for s in cur:
                        returns.append((stmt, s))
                    cur = set()
                elif isinstance(stmt, ast.Raise):
                    cur = set()  # exceptional exits are exempt by design
                elif isinstance(stmt, ast.Break):
                    breaks |= cur
                    cur = set()
                elif isinstance(stmt, ast.Continue):
                    continues |= cur
                    cur = set()
                elif isinstance(stmt, ast.If):
                    n1, b1, c1, d1 = exec_block(stmt.body, cur)
                    n2, b2, c2, d2 = exec_block(stmt.orelse, cur)
                    cur = n1 | n2
                    breaks |= b1 | b2
                    continues |= c1 | c2
                    during |= d1 | d2
                elif isinstance(stmt, (ast.While, ast.For)):
                    entry = cur
                    n, b, c, d = exec_block(stmt.body, entry)
                    during |= d
                    if not untainted(n | c) <= untainted(entry):
                        loop_bad.append(stmt)
                    infinite = (isinstance(stmt, ast.While)
                                and isinstance(stmt.test, ast.Constant)
                                and bool(stmt.test.value))
                    cur = (b if infinite else entry | b)
                    if stmt.orelse:
                        cur, b2, c2, d2 = exec_block(stmt.orelse, cur)
                        breaks |= b2
                        continues |= c2
                        during |= d2
                elif isinstance(stmt, ast.Try):
                    n, b, c, d = exec_block(stmt.body, cur)
                    during |= d
                    # an exception can surface at any body state: handlers
                    # enter with every depth seen during the body, tainted
                    # (exceptional paths are forgiven, but the handler's own
                    # cancel()/reset() must still shape what flows onward)
                    hentry = {(depths, True) for depths, _t in d}
                    hn: Set[tuple] = set()
                    hb: Set[tuple] = set()
                    hc: Set[tuple] = set()
                    for handler in stmt.handlers:
                        n3, b3, c3, d3 = exec_block(handler.body, hentry)
                        hn |= n3
                        hb |= b3
                        hc |= c3
                        during |= d3
                    if stmt.orelse:
                        n, b4, c4, d4 = exec_block(stmt.orelse, n)
                        b |= b4
                        c |= c4
                        during |= d4
                    n |= hn
                    b |= hb
                    c |= hc
                    if stmt.finalbody:
                        def through(states_in):
                            out, _fb, _fc, fd = exec_block(stmt.finalbody,
                                                           states_in)
                            during.update(fd)
                            return out
                        # returns recorded inside the try ran the finally
                        # first: re-map the recorded states
                        fixed = []
                        for node, s in returns:
                            if (stmt.lineno <= node.lineno
                                    and node.end_lineno >= node.lineno
                                    and node.end_lineno <= stmt.end_lineno):
                                for s2 in through({s}) or {s}:
                                    fixed.append((node, s2))
                            else:
                                fixed.append((node, s))
                        returns[:] = fixed
                        n = through(n) if n else n
                        b = through(b) if b else b
                        c = through(c) if c else c
                    cur = n
                    breaks |= b
                    continues |= c
                elif isinstance(stmt, ast.With):
                    n, b, c, d = exec_block(stmt.body, cur)
                    cur = n
                    breaks |= b
                    continues |= c
                    during |= d
                else:
                    cur = {apply_stmt(stmt, s) for s in cur}
                during |= cur
            return cur, breaks, continues, during

        final, _b, _c, _d = exec_block(func.body, {zero})
        for stmt, state in returns:
            if state[1]:
                continue  # exceptional path — forgiven
            for r, i in idx.items():
                if state[0][i] > 0:
                    self.emit(
                        "span-pairing", stmt,
                        f"returns with {state[0][i]} open span(s) on {r} — "
                        "call end() (or cancel() on abort paths) before "
                        "this return", func)
        for state in untainted(final):
            for r, i in idx.items():
                if state[0][i] > 0:
                    self.emit(
                        "span-pairing", func,
                        f"function can complete with {state[0][i]} open "
                        f"span(s) on {r} — begin() without end()/cancel()",
                        func)
        for stmt in loop_bad:
            for r in recvs:
                self.emit(
                    "span-pairing", stmt,
                    f"loop body leaves {r}'s open-span depth changed "
                    "across an iteration — begin()/end() unbalanced "
                    "inside the loop", func)
                break

    # -- rule: donated-reuse -------------------------------------------------
    def _donation_registry(self) -> Dict[str, List[Tuple[int, ...]]]:
        """name (last dotted component) -> donated position tuples, from
        ``<name> = jax.jit(..., donate_argnums=...)`` in this module."""
        reg: Dict[str, List[Tuple[int, ...]]] = {}
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            call = node.value
            if not (isinstance(call, ast.Call)
                    and _dotted(call.func) in ("jax.jit", "jit")):
                continue
            pos: Optional[Tuple[int, ...]] = None
            for kw in call.keywords:
                if kw.arg == "donate_argnums":
                    v = kw.value
                    if isinstance(v, ast.Constant) and isinstance(v.value, int):
                        pos = (v.value,)
                    elif isinstance(v, (ast.Tuple, ast.List)) and all(
                            isinstance(e, ast.Constant) for e in v.elts):
                        pos = tuple(e.value for e in v.elts)
                    elif isinstance(v, ast.IfExp):
                        # `(0, 1, 5) if fused else (0, 1)`: union — a
                        # position donated under either branch is hot
                        cands = []
                        for side in (v.body, v.orelse):
                            if isinstance(side, (ast.Tuple, ast.List)) and all(
                                    isinstance(e, ast.Constant)
                                    for e in side.elts):
                                cands.extend(e.value for e in side.elts)
                        pos = tuple(sorted(set(cands))) if cands else None
            if pos is None:
                continue
            target = _dotted(node.targets[0])
            if target is None:
                continue
            reg.setdefault(target.rsplit(".", 1)[-1], []).append(pos)
        return reg

    def _check_donated(self, func: ast.AST,
                       reg: Dict[str, List[Tuple[int, ...]]]) -> None:
        if not reg:
            return
        # parent statement of every node in this function's direct scope
        stmt_of: Dict[int, ast.stmt] = {}
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                stmt_of.setdefault(id(node), stmt)
        loads: List[Tuple[int, str]] = []
        stores: List[Tuple[int, str]] = []
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                if isinstance(node, (ast.Name, ast.Attribute)):
                    key = _dotted(node)
                    if key is None:
                        continue
                    if isinstance(node.ctx, ast.Store):
                        stores.append((node.lineno, key))
                    elif isinstance(node.ctx, ast.Load):
                        loads.append((node.lineno, key))
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                fname = _dotted(node.func)
                if fname is None:
                    continue
                sets = reg.get(fname.rsplit(".", 1)[-1])
                if not sets:
                    continue
                call_stmt = stmt_of.get(id(node), stmt)
                end = getattr(call_stmt, "end_lineno", call_stmt.lineno)
                for positions in sets:
                    for p in positions:
                        if p >= len(node.args):
                            continue
                        key = _dotted(node.args[p])
                        if key is None:
                            continue
                        for lline, lkey in loads:
                            if lkey != key or lline <= end:
                                continue
                            redefined = any(
                                skey == key
                                and call_stmt.lineno <= sline <= lline
                                for sline, skey in stores)
                            if not redefined:
                                self.emit(
                                    "donated-reuse", node,
                                    f"{key} is donated (arg {p} of "
                                    f"{fname}) but read again on line "
                                    f"{lline} — its buffer is deleted the "
                                    "moment the call dispatches", func)
                                break

    # -- rule: hot-path-sync -------------------------------------------------
    def _is_hot(self, func: ast.AST, qual: str) -> bool:
        if qual in HOT_PATH_QUALNAMES:
            return True
        for line in (func.lineno, func.lineno - 1):
            if 1 <= line <= len(self.lines) and _HOT_RE.search(
                    self.lines[line - 1]):
                return True
        return False

    def _check_hot_path(self, func: ast.AST, qual: str) -> None:
        if not self._is_hot(func, qual):
            return
        for stmt in _direct_statements(func):
            for node in _direct_expr_walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                msg = None
                if (isinstance(node.func, ast.Name)
                        and node.func.id in _SYNC_CALLS
                        and node.args
                        and not isinstance(node.args[0], ast.Constant)):
                    msg = (f"{node.func.id}() on a runtime value blocks on "
                           "device execution")
                elif isinstance(node.func, ast.Attribute):
                    if node.func.attr == "synchronize":
                        msg = (f"{_dotted(node.func) or '.synchronize'}() "
                               "waits for the card")
                    elif node.func.attr in _SYNC_ATTRS:
                        msg = f".{node.func.attr}() syncs device to host"
                    elif _dotted(node.func) in _SYNC_DOTTED:
                        msg = (f"{_dotted(node.func)}() pulls the value to "
                               "host")
                if msg is not None:
                    self.emit(
                        "hot-path-sync", node,
                        f"host sync in # hot-path function "
                        f"{qual}: {msg}", func)

    # -- rule: hostenv-picklable ---------------------------------------------
    def _check_hostenv(self) -> None:
        module_defs: Set[str] = set()
        local_defs: Set[str] = set()
        lambda_names: Set[str] = set()
        for node, qual, depth in self.functions:
            (local_defs if depth > 0 else module_defs).add(
                qual.rsplit(".", 1)[-1])
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Lambda)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lambda_names.add(t.id)
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and _dotted(node.func) is not None
                    and _dotted(node.func).rsplit(".", 1)[-1]
                    == "HostEnvSpec"):
                continue
            env_fn = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "env_fn":
                    env_fn = kw.value
            if env_fn is None:
                continue
            if isinstance(env_fn, ast.Lambda):
                self.emit(
                    "hostenv-picklable", env_fn,
                    "HostEnvSpec(env_fn=<lambda>): lambdas cannot pickle "
                    "into spawned workers — use a module-level function")
            elif isinstance(env_fn, ast.Name):
                n = env_fn.id
                if n in lambda_names or (n in local_defs
                                         and n not in module_defs):
                    self.emit(
                        "hostenv-picklable", env_fn,
                        f"HostEnvSpec(env_fn={n}): bound to a lambda or "
                        "locally-defined function — only module-level "
                        "callables survive pickling into spawned workers")


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    return _FileLint(path, source).run()


def _iter_py_files(paths: Sequence[str]):
    for p in paths:
        pth = Path(p)
        if pth.is_dir():
            yield from sorted(pth.rglob("*.py"))
        elif pth.suffix == ".py":
            yield pth
        else:
            raise FileNotFoundError(f"not a .py file or directory: {p}")


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in _iter_py_files(paths):
        try:
            src = f.read_text()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(str(f), 1, "parse",
                                    f"unreadable: {e}"))
            continue
        try:
            findings.extend(lint_source(src, str(f)))
        except SyntaxError as e:
            findings.append(Finding(str(f), e.lineno or 1, "parse",
                                    f"syntax error: {e.msg}"))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repro-lint of the port: stdlib-ast invariant checks "
                    "(the module docstring has the rule catalog)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                    "src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        return 0
    try:
        findings = lint_paths(args.paths)
    except FileNotFoundError as e:
        print(f"repro-lint: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f)
    n_files = len(list(_iter_py_files(args.paths)))
    status = f"{len(findings)} finding(s)" if findings else "clean"
    print(f"repro-lint: {n_files} file(s), {status}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
