#!/usr/bin/env python3
"""racelint — guarded-by concurrency lint for the host-side thread fleet.

The port's own copy of the JAX package's ``analysis/racelint.py``: the
same rules, ids, pragmas and findings, over the port's tree
(``python -m cxxnet_tpu_torch.analysis.racelint cxxnet_tpu_torch/``).
The port imports nothing of the JAX package, so it keeps this copy;
``tests/test_torch_threadcheck.py`` holds the two to identical findings
on both trees, so the copy cannot drift.

Third leg of the static-analysis stack: graftlint checks configs,
spmdlint checks the device program, racelint checks the host program.
The serving/checkpoint/io planes run a fleet of Python threads
(MicroBatcher/StepScheduler dispatchers, DevicePrefetcher producers,
AsyncCheckpointWriter, the serve-sentinel reporter, AdminServer's
acceptor and per-connection handlers).  The same bug class — an
attribute touched from two threads without a declared discipline — has
been re-found by hand at least four times.  racelint encodes the
discipline once and enforces it tree-wide.

Model
-----
Per class, discover every *thread context*:

* ``threading.Thread(target=self._m)``  → worker context ``_m``
* ``threading.Thread(target=local_fn)`` → worker context ``local_fn``
  (a function defined in the same method)
* a ``run()`` override on a ``Thread`` subclass
* a request-handler class nested in a method (``BaseHTTPRequestHandler``
  subclass reaching the owner through an ``alias = self`` binding) —
  context ``handler``, which counts as *many* threads (ThreadingHTTPServer
  spawns one per connection)
* an explicit ``# racelint: thread(<name>)`` marker on a ``def`` — for
  entry points invoked from foreign threads the AST cannot see (e.g.
  ``Histogram.observe`` called from every serve client).  The reserved
  name ``shared`` means "many concurrent threads at once".

Everything not reachable from a worker entry runs in the ``client``
context (the constructing/driving thread).  ``__init__`` (and the
iterator contract's pre-thread ``init``/``set_param``) is *construction*:
its writes declare attributes, they are not mutations.

Any attribute written post-construction and touched from more than one
context must carry a policy comment on its declaration line::

    self._pending = 0        # racelint: guarded-by(self._lock)
    self.n_requests = 0      # racelint: atomic(plain-int bump, single writer)
    self._failed = None      # racelint: latch(write-once then read)

``guarded-by`` is verified lexically: every access must sit inside a
``with`` on one of the named locks (several spellings may alias one lock,
e.g. a ``Condition`` wrapping it).  ``atomic`` documents the GIL-atomic
whitelist (plain-int bumps with a single writer, whole-object swaps,
``copy_racy`` reads); a read-modify-write on an atomic attribute from
more than one context is still an error — the whitelist does not cover
lost updates.  ``latch`` is the failure-latch idiom: whole-object
write-once-ish stores, racy reads tolerated by design.

Findings (all ERROR severity; stable ids):

==================== ====================================================
race_undeclared      attribute mutated cross-thread with no policy
race_unguarded       guarded-by attribute touched outside its lock
race_check_then_act  guarded test and dependent write under different
                     lock acquisitions
race_rmw             read-modify-write of an atomic/latch attribute from
                     concurrent contexts
race_thread_name     ``Thread(...)`` without a ``cxxnet-*`` name
race_bad_decl        malformed policy (empty reason, unknown lock, ...)
race_pragma_reason   suppression pragma without a written reason
race_parse           file does not parse
==================== ====================================================

Escape hatch (a reason is mandatory — satellite rule: no pragma without
a written reason)::

    x = f()  # racelint: ok(race_unguarded) — watermark is a GIL-atomic read
    # racelint: ok-file(race_thread_name) — fixture threads are anonymous

Zero third-party imports; runnable standalone (``python
cxxnet_tpu_torch/analysis/racelint.py --json``) so the tier-1 gate pays
no framework import cost.  ``monitor/threadcheck.py``
(the runtime lock-witness) reuses :func:`collect_policies` to learn
which attributes are guarded by which locks.
"""

# disclint: ok-file(print) — standalone CLI; stdout is the product surface

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = (
    "race_undeclared", "race_unguarded", "race_check_then_act",
    "race_rmw", "race_thread_name", "race_bad_decl",
    "race_pragma_reason", "race_parse",
)

# construction contexts: the object-isn't-shared-yet window.  __init__ by
# definition; init/set_param by the iterator contract (factory calls them
# before before_first starts any producer thread).
CONSTRUCTION_METHODS = ("__init__", "__post_init__", "init", "set_param")

# context names with more than one concurrent thread behind them: a
# single-context RMW is still a lost update there
SHARED_CONTEXTS = ("handler", "shared")

# mutating container methods: ``self._ring.append(x)`` is a write to
# ``_ring`` even though the attribute itself is only Load-ed.  Queue
# put/get are deliberately absent (queue.Queue is internally locked).
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "add", "update",
    "sort", "reverse", "rotate",
})
# single C-level dict ops: mutations, but check-and-act in one bytecode —
# they cannot lose a concurrent update, so they satisfy ``atomic``
_ATOMIC_MUTATORS = frozenset({"setdefault"})

_PRAGMA = re.compile(
    r"#\s*racelint:\s*(ok-file|ok)\s*"
    r"(?:\(([^)]*)\))?\s*(?:[—–-]+\s*(\S.*))?")
_POLICY = re.compile(
    r"#\s*racelint:\s*(guarded-by|atomic|latch)\s*\(([^)]*)\)")
_THREAD_MARK = re.compile(r"#\s*racelint:\s*thread\s*\(([^)]*)\)")
_ANY_DIRECTIVE = re.compile(r"#\s*racelint:")

DEFAULT_PATHS = ("cxxnet_tpu_torch",)


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Policy:
    kind: str            # guarded-by | atomic | latch
    args: Tuple[str, ...]  # lock attr names for guarded-by, (reason,) else
    line: int
    comment_only: bool = True  # directive on its own line (may attach to
    #                            the assignment BELOW); a trailing
    #                            directive only covers its own line


@dataclasses.dataclass
class Access:
    attr: str
    kind: str            # "read" | "write"
    rmw: bool            # read-modify-write (AugAssign / container mutator)
    line: int
    ctx_method: str      # method the access lexically lives in
    locks: Tuple[str, ...]   # self-attr locks held (enclosing with blocks)
    with_id: Optional[int]   # id of innermost lock-with (check-then-act)


# --------------------------------------------------------------------------
# source-comment harvesting


def _pragmas(src: str):
    """Return (per_line, file_wide, reasonless_lines).

    per_line: {lineno: set(rules) or None (= all rules)}
    file_wide: set(rules) or None
    reasonless_lines: pragma sites missing the mandatory reason text.
    """
    per_line: Dict[int, Optional[Set[str]]] = {}
    file_wide: Optional[Set[str]] = set()
    has_file_wide = False
    reasonless: List[int] = []
    for i, text in enumerate(src.splitlines(), start=1):
        m = _PRAGMA.search(text)
        if not m:
            continue
        which, rules, reason = m.group(1), m.group(2), m.group(3)
        ruleset = (set(r.strip() for r in rules.split(",") if r.strip())
                   if rules else None)
        if not (reason and reason.strip()):
            reasonless.append(i)
        if which == "ok-file":
            has_file_wide = True
            if ruleset is None:
                file_wide = None
            elif file_wide is not None:
                file_wide |= ruleset
        else:
            per_line[i] = ruleset
    if not has_file_wide:
        file_wide = set()
    return per_line, file_wide, reasonless


def _suppressed(f: Finding, per_line, file_wide) -> bool:
    if file_wide is None or f.rule in file_wide:
        return True
    for ln in (f.line, f.line - 1):
        if ln in per_line:
            rules = per_line[ln]
            if rules is None or f.rule in rules:
                return True
    return False


def _line_directives(src: str):
    """Map lineno -> (policy | thread-mark | pragma | malformed)."""
    policies: Dict[int, Policy] = {}
    thread_marks: Dict[int, str] = {}
    malformed: List[Tuple[int, str]] = []
    for i, text in enumerate(src.splitlines(), start=1):
        if not _ANY_DIRECTIVE.search(text):
            continue
        m = _POLICY.search(text)
        if m:
            kind, raw = m.group(1), m.group(2)
            args = tuple(a.strip() for a in raw.split(",")) \
                if kind == "guarded-by" else (raw.strip(),)
            policies[i] = Policy(kind, args, i,
                                 text.lstrip().startswith("#"))
            continue
        m = _THREAD_MARK.search(text)
        if m:
            thread_marks[i] = m.group(1).strip()
            continue
        if _PRAGMA.search(text):
            continue
        malformed.append((i, text.strip()))
    return policies, thread_marks, malformed


# --------------------------------------------------------------------------
# AST helpers


def _set_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._racelint_parent = node  # type: ignore[attr-defined]


def _parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_racelint_parent", None)


def _is_thread_ctor(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        return True
    if isinstance(fn, ast.Name) and fn.id == "Thread":
        return True
    return False


def _thread_name_ok(call: ast.Call) -> bool:
    """name= must be a literal (or f-string head) starting with cxxnet-."""
    for kw in call.keywords:
        if kw.arg != "name":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return v.value.startswith("cxxnet-")
        if isinstance(v, ast.JoinedStr) and v.values:
            head = v.values[0]
            return (isinstance(head, ast.Constant)
                    and isinstance(head.value, str)
                    and head.value.startswith("cxxnet-"))
        return False  # dynamic name: cannot verify, demand a literal head
    return False


def _self_attr(node: ast.AST, selves: Set[str]) -> Optional[str]:
    """``self.x`` (or ``alias.x`` for a known self-alias) -> ``x``."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id in selves:
        return node.attr
    return None


# --------------------------------------------------------------------------
# per-class analysis


class _ClassScan:
    """One class: methods, entries, call edges, accesses."""

    def __init__(self, cls: ast.ClassDef, policies: Dict[int, Policy],
                 thread_marks: Dict[int, str]):
        self.cls = cls
        self.name = cls.name
        self.methods: Dict[str, ast.AST] = {}
        # entry method -> (context name, shared?)
        self.entries: Dict[str, Tuple[str, bool]] = {}
        self.edges: Dict[str, Set[str]] = {}
        self.accesses: List[Access] = []
        self.policy: Dict[str, Policy] = {}      # attr -> policy
        self.decl_lines: Dict[str, int] = {}     # attr -> first decl line
        self.lock_attrs: Set[str] = set()        # attrs ever used as a lock
        self.assigned_attrs: Set[str] = set()
        self._policies = policies
        self._thread_marks = thread_marks
        # nodes that are Thread(target=...) references, NOT call edges
        self._target_refs: Set[int] = set()
        self._is_thread_subclass = any(
            (isinstance(b, ast.Name) and b.id == "Thread") or
            (isinstance(b, ast.Attribute) and b.attr == "Thread")
            for b in cls.bases)
        self._collect_methods()
        self._discover_entries()
        self._walk_methods()

    # -- structure -----------------------------------------------------

    def _collect_methods(self) -> None:
        for node in self.cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[node.name] = node

    def _marker_for(self, fn: ast.AST) -> Optional[str]:
        """thread(<name>) marker on the def line or the line above it
        (decorators shift lineno, so scan decorator lines too)."""
        lines = [fn.lineno, fn.lineno - 1]
        for dec in getattr(fn, "decorator_list", []):
            lines += [dec.lineno, dec.lineno - 1]
        for ln in lines:
            if ln in self._thread_marks:
                return self._thread_marks[ln]
        return None

    def _discover_entries(self) -> None:
        if self._is_thread_subclass and "run" in self.methods:
            self.entries["run"] = ("run", False)
        for mname, fn in self.methods.items():
            mark = self._marker_for(fn)
            if mark:
                self.entries[mname] = (mark, mark in SHARED_CONTEXTS)
            local_defs = {n.name for n in ast.walk(fn)
                          if isinstance(n, ast.FunctionDef) and n is not fn}
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and _is_thread_ctor(node)):
                    continue
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    tgt = kw.value
                    attr = _self_attr(tgt, {"self"})
                    if attr and attr in self.methods:
                        self.entries.setdefault(attr, (attr, False))
                        self._target_refs.add(id(tgt))
                    elif isinstance(tgt, ast.Name) and \
                            tgt.id in local_defs:
                        self.entries.setdefault(
                            f"{mname}.{tgt.id}", (tgt.id, False))

    # -- body walk -----------------------------------------------------

    def _walk_methods(self) -> None:
        for mname, fn in self.methods.items():
            self._walk_body(fn, ctx_method=mname, selves={"self"})

    def _walk_body(self, fn: ast.AST, ctx_method: str,
                   selves: Set[str]) -> None:
        """Collect accesses/edges for one method, recursing into nested
        defs (worker-target closures get their own context; other
        closures inherit), and nested handler classes (alias = self)."""
        selves = set(selves)
        lock_stack: List[Tuple[str, int]] = []  # (lock attr, with-node id)

        nested_entries = {
            key.split(".", 1)[1] for key in self.entries
            if key.startswith(ctx_method + ".")}

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.FunctionDef) and node is not fn:
                if node.name in nested_entries and "." not in ctx_method:
                    # worker-target closure: its own thread context
                    self._walk_body(node, f"{ctx_method}.{node.name}",
                                    selves)
                else:  # plain closure: runs in the enclosing context
                    for child in ast.iter_child_nodes(node):
                        visit(child)
                return
            if isinstance(node, ast.ClassDef):
                self._walk_handler_class(node, ctx_method, selves)
                return
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in selves:
                for t in node.targets:  # alias = self
                    if isinstance(t, ast.Name):
                        selves.add(t.id)
            if isinstance(node, ast.With):
                entered = []
                for item in node.items:
                    lk = _self_attr(item.context_expr, selves)
                    if lk is not None:
                        entered.append(lk)
                        self.lock_attrs.add(lk)
                for lk in entered:
                    lock_stack.append((lk, id(node)))
                for child in ast.iter_child_nodes(node):
                    visit(child)
                for _ in entered:
                    lock_stack.pop()
                return
            self._record(node, ctx_method, selves, lock_stack)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for child in ast.iter_child_nodes(fn):
            visit(child)

    def _walk_handler_class(self, cls: ast.ClassDef, ctx_method: str,
                            selves: Set[str]) -> None:
        """A request-handler class nested in a method: its methods run on
        per-connection server threads; the outer object is reached via an
        ``alias = self`` captured name, never ``self`` (which rebinds to
        the handler instance).  Non-handler nested classes just inherit
        the enclosing context."""
        outer = selves - {"self"}
        is_handler = any("Handler" in ast.dump(b) for b in cls.bases)
        for node in cls.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if is_handler and outer:
                self.entries.setdefault(
                    f"handler.{node.name}", ("handler", True))
                self._walk_body(node, f"handler.{node.name}", outer)
            else:
                self._walk_body(node, ctx_method, selves - {"self"})

    def _record(self, node: ast.AST, ctx_method: str, selves: Set[str],
                lock_stack) -> None:
        attr = _self_attr(node, selves)
        if attr is None:
            return
        if id(node) in self._target_refs:
            return  # Thread(target=self._m): context seed, not a call
        if attr in self.methods:
            # self.m(...) call or self.prop read: a call-graph edge (the
            # callee runs in this context), not a data access
            self.edges.setdefault(ctx_method, set()).add(attr)
            return
        parent = _parent(node)
        locks = tuple(lk for lk, _ in lock_stack)
        with_id = lock_stack[-1][1] if lock_stack else None
        line = node.lineno

        def add(kind: str, rmw: bool = False) -> None:
            self.accesses.append(Access(
                attr, kind, rmw, line, ctx_method, locks, with_id))

        if isinstance(node.ctx, (ast.Store, ast.Del)):  # type: ignore
            self.assigned_attrs.add(attr)
            if attr not in self.decl_lines:
                self.decl_lines[attr] = line
            pol = self._policies.get(line)
            if pol is None:
                prev = self._policies.get(line - 1)
                if prev is not None and prev.comment_only:
                    pol = prev
            if pol and attr not in self.policy:
                self.policy[attr] = pol
            rmw = isinstance(parent, ast.AugAssign)
            add("write", rmw=rmw)
            if rmw:
                add("read")
            return
        # Load context: classify container mutation / subscript store
        if isinstance(parent, ast.Subscript) and parent.value is node:
            gp = _parent(parent)
            sub_store = isinstance(parent.ctx, (ast.Store, ast.Del))
            sub_aug = isinstance(gp, ast.AugAssign) and gp.target is parent
            if sub_store or sub_aug:
                add("write", rmw=sub_aug)
                if sub_aug:
                    add("read")
                return
        if isinstance(parent, ast.Attribute) and parent.value is node:
            gp = _parent(parent)
            if isinstance(gp, ast.Call) and gp.func is parent and \
                    parent.attr in _MUTATORS:
                add("write", rmw=True)
                return
            if isinstance(gp, ast.Call) and gp.func is parent and \
                    parent.attr in _ATOMIC_MUTATORS:
                add("write", rmw=False)
                return
        add("read")

    # -- context propagation -------------------------------------------

    def contexts(self) -> Dict[str, Set[Tuple[str, bool]]]:
        """method-or-entry key -> set of (context, shared) it runs in."""
        ctx: Dict[str, Set[Tuple[str, bool]]] = \
            {m: set() for m in self.methods}
        for key in self.edges:
            ctx.setdefault(key, set())
        for key, (cname, shared) in self.entries.items():
            ctx.setdefault(key, set()).add((cname, shared))
        # client seeds: plain methods nobody in-class calls and that are
        # not worker entries — they are driven by the owning thread
        called: Set[str] = set()
        for tos in self.edges.values():
            called |= tos
        for m in self.methods:
            if m not in self.entries and m not in called:
                ctx[m].add(("client", False))
        # fixpoint over call edges (nested-entry keys "m.f" call through
        # their own edges entry if any)
        changed = True
        while changed:
            changed = False
            for frm, tos in self.edges.items():
                src = ctx.get(frm, set())
                for to in tos:
                    if to in ctx and not src <= ctx[to]:
                        ctx[to] |= src
                        changed = True
        return ctx


def _ctx_weight(ctxs: Set[Tuple[str, bool]]) -> int:
    """Concurrency degree of a context set: distinct names, shared
    contexts counting double."""
    n = 0
    for _, shared in ctxs:
        n += 2 if shared else 1
    return n


def _lint_class(scan: _ClassScan, path: str,
                findings: List[Finding]) -> None:
    ctx_of = scan.contexts()

    def ctxs_at(acc: Access) -> Set[Tuple[str, bool]]:
        return ctx_of.get(acc.ctx_method, {("client", False)})

    has_worker = any(
        c != "client" for cs in ctx_of.values() for c, _ in cs)

    # policy sanity — verified even in worker-less classes so stale
    # annotations cannot rot silently
    for attr, pol in scan.policy.items():
        if pol.kind == "guarded-by":
            bad = [a for a in pol.args
                   if not a.startswith("self.")
                   or a[5:] not in scan.assigned_attrs]
            if bad or not pol.args or not pol.args[0]:
                findings.append(Finding(
                    path, pol.line, "race_bad_decl",
                    f"{scan.name}.{attr}: guarded-by names "
                    f"{', '.join(bad) or 'nothing'} — each must be a "
                    "self.<lock> assigned in this class"))
        elif not pol.args[0]:
            findings.append(Finding(
                path, pol.line, "race_bad_decl",
                f"{scan.name}.{attr}: {pol.kind}() needs a written "
                "reason (the whitelist is documented, not assumed)"))

    by_attr: Dict[str, List[Access]] = {}
    for acc in scan.accesses:
        by_attr.setdefault(acc.attr, []).append(acc)

    for attr, accs in sorted(by_attr.items()):
        pol = scan.policy.get(attr)
        live = [a for a in accs
                if a.ctx_method.split(".", 1)[0]
                not in CONSTRUCTION_METHODS]
        if pol is not None and pol.kind == "guarded-by":
            locks = {a[5:] for a in pol.args if a.startswith("self.")}
            for a in live:
                if not (set(a.locks) & locks):
                    findings.append(Finding(
                        path, a.line, "race_unguarded",
                        f"{scan.name}.{attr} touched outside its "
                        f"declared lock ({', '.join(sorted(locks))}) — "
                        "hold the lock, or re-declare the policy"))
            _check_then_act(scan, attr, locks, path, findings)
            continue
        # cross-thread mutation detection
        writes = [a for a in live if a.kind == "write"]
        if not writes:
            continue
        all_ctxs: Set[Tuple[str, bool]] = set()
        for a in live:
            all_ctxs |= ctxs_at(a)
        if _ctx_weight(all_ctxs) < 2 or not has_worker:
            continue
        write_ctxs: Set[Tuple[str, bool]] = set()
        for a in writes:
            write_ctxs |= ctxs_at(a)
        if pol is None:
            names = sorted({c for c, _ in all_ctxs})
            findings.append(Finding(
                path, scan.decl_lines.get(attr, writes[0].line),
                "race_undeclared",
                f"{scan.name}.{attr} is mutated across thread contexts "
                f"({', '.join(names)}) with no declared policy — "
                "annotate guarded-by(self.<lock>) / atomic(reason) / "
                "latch(reason) on its declaration"))
            continue
        # atomic / latch: RMW from concurrent contexts is a lost update
        rmw_ctxs: Set[Tuple[str, bool]] = set()
        for a in writes:
            if a.rmw:
                rmw_ctxs |= ctxs_at(a)
        if rmw_ctxs and _ctx_weight(rmw_ctxs) >= 2:
            a = next(x for x in writes if x.rmw)
            findings.append(Finding(
                path, a.line, "race_rmw",
                f"{scan.name}.{attr} is declared {pol.kind} but is "
                "read-modify-written from concurrent contexts "
                f"({', '.join(sorted(c for c, _ in rmw_ctxs))}) — the "
                "GIL-atomic whitelist does not cover lost updates; "
                "guard it with a lock"))


def _check_then_act(scan: _ClassScan, attr: str, locks: Set[str],
                    path: str, findings: List[Finding]) -> None:
    """A guarded test and a guarded dependent write under *different*
    lock acquisitions: each access is locked, the decision is not."""
    reads = {a.line: a for a in scan.accesses
             if a.attr == attr and a.kind == "read" and a.with_id}
    writes = [a for a in scan.accesses
              if a.attr == attr and a.kind == "write" and a.with_id]
    for node in ast.walk(scan.cls):
        if not isinstance(node, ast.If):
            continue
        test_accs = [reads[n.lineno] for n in ast.walk(node.test)
                     if _self_attr(n, {"self"}) == attr
                     and n.lineno in reads]
        if not test_accs:
            continue
        body_lines = set()
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if hasattr(sub, "lineno"):
                    body_lines.add(sub.lineno)
        for w in writes:
            if w.line in body_lines and \
                    w.with_id != test_accs[0].with_id:
                findings.append(Finding(
                    path, w.line, "race_check_then_act",
                    f"{scan.name}.{attr}: the test at line "
                    f"{test_accs[0].line} and this write hold "
                    f"{'/'.join(sorted(locks))} separately — the "
                    "condition can go stale between them; widen to one "
                    "acquisition"))


# --------------------------------------------------------------------------
# file / tree driver


def lint_file(path: str, src: Optional[str] = None) -> List[Finding]:
    if src is None:
        with open(path, encoding="utf-8") as fo:
            src = fo.read()
    findings: List[Finding] = []
    per_line, file_wide, reasonless = _pragmas(src)
    for ln in reasonless:
        findings.append(Finding(
            path, ln, "race_pragma_reason",
            "suppression pragma without a reason — write one: "
            "`# racelint: ok(rule) — why this is safe`"))
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        findings.append(Finding(
            path, e.lineno or 1, "race_parse",
            f"file does not parse: {e.msg}"))
        return findings
    _set_parents(tree)
    policies, thread_marks, malformed = _line_directives(src)
    for ln, text in malformed:
        findings.append(Finding(
            path, ln, "race_bad_decl",
            f"unrecognized racelint directive: {text!r}"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_thread_ctor(node) \
                and not _thread_name_ok(node):
            findings.append(Finding(
                path, node.lineno, "race_thread_name",
                "Thread without a literal cxxnet-* name= — unnamed "
                "threads are unattributable in span/flight captures"))
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            scan = _ClassScan(node, policies, thread_marks)
            _lint_class(scan, path, findings)
    return [f for f in findings
            if not _suppressed(f, per_line, file_wide)]


def collect_policies(path: str, src: Optional[str] = None
                     ) -> Dict[str, Dict[str, Policy]]:
    """{class name: {attr: Policy}} for one file — the lock-witness
    sanitizer (monitor/threadcheck.py) derives its attr→lock map from
    the same parser the lint uses, so the two can never disagree."""
    if src is None:
        with open(path, encoding="utf-8") as fo:
            src = fo.read()
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return {}
    _set_parents(tree)
    policies, thread_marks, _ = _line_directives(src)
    out: Dict[str, Dict[str, Policy]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            scan = _ClassScan(node, policies, thread_marks)
            if scan.policy:
                out[node.name] = dict(scan.policy)
    return out


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in sorted(dirs)
                           if d != "__pycache__"]
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        yield os.path.join(root, fn)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    paths = argv or [p for p in DEFAULT_PATHS if os.path.exists(p)]
    findings: List[Finding] = []
    n_files = 0
    for path in iter_py_files(paths):
        n_files += 1
        findings.extend(lint_file(path))
    code = 1 if findings else 0
    if as_json:
        print(json.dumps({
            "kind": "racelint", "n_files": n_files, "exit": code,
            "findings": [dataclasses.asdict(f) for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f)
        print(f"racelint: {n_files} files, {len(findings)} finding(s)")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
