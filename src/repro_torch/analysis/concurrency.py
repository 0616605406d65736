"""Concurrency lint: an AST pass over the threaded layers.

Scope (default): ``src/repro_torch/serving``, ``src/repro_torch/runtime``,
``src/repro_torch/kernels/native.py`` and ``src/repro_torch/kernels/autotune.py``
— everything that takes locks.
The port's copy of the reference's lint (``repro.analysis.concurrency``):
the same rules, suppression syntax and stats, so the two packages' reports
compare finding for finding.

Rules:

- ``CONC-GUARD`` (error): a field annotated ``# guarded-by: <lock>`` is
  mutated outside a ``with <lock>:`` block.  Guards name a real lock
  (``self._lock``, ``self.not_empty``, module-level ``_LOCK``) and are
  *checked*; non-identifier guard values (``engine-thread``,
  ``control-thread``) declare a single-writer discipline and are
  documentation only.  ``__init__``/``__post_init__`` are exempt (no
  concurrent access before construction completes).
- ``CONC-GUARD-UNKNOWN`` (warning): a checked-style guard names a lock
  the lint cannot find — a typo'd annotation must not silently disable
  checking.
- ``CONC-ORDER`` (error): the lock-acquisition-order graph (edges
  ``A -> B`` when B is acquired while A is held, including through
  self-method calls) contains a cycle — a deadlock risk.
- ``CONC-SELF-DEADLOCK`` (error): a non-reentrant ``threading.Lock`` is
  re-acquired while already held (lexically or through a self-method
  call) — guaranteed deadlock on that path.
- ``CONC-WAIT-LOOP`` (warning): ``Condition.wait`` outside a ``while``
  predicate loop — wakeups are spurious and conditions must be re-checked.
  ``Event.wait`` is level-triggered and exempt.
- ``CONC-THREAD-LIFECYCLE`` (warning): a class starts threads / timers /
  executors but has no ``join``/``shutdown``/``cancel`` call anywhere —
  no teardown path means leaked threads under repeated construction.

Suppression: append ``# analysis: allow(RULE-NAME)`` to the flagged line.

The lint is intentionally *intra-module* with limited type inference
(``self.x = ClassName(...)``, annotated parameters, local aliases): it
resolves lock identity to canonical ``ClassName.attr`` / ``module:NAME``
ids and propagates held-lock sets through private (``_``-prefixed)
self-method calls by fixpoint (entry set = intersection over internal
call sites).  Calls it cannot resolve are skipped, never guessed — the
lint prefers missed findings over false positives.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable

from .findings import Report, Severity

GUARD_RE = re.compile(r"#\s*guarded-by:\s*([^#\n]+?)\s*(?:#|$)")
ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([A-Z0-9-]+)\)")
IDENT_RE = re.compile(r"^(self\.)?[A-Za-z_][A-Za-z0-9_]*$")

# method names that mutate their receiver in place
MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "appendleft", "popleft",
    "sort", "reverse",
}

# threading factory name -> kind
FACTORY_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Event": "event",
    "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore",
    "Barrier": "barrier",
}
LOCKY_KINDS = {"lock", "rlock", "condition", "semaphore"}
THREAD_FACTORIES = {"Thread", "Timer", "ThreadPoolExecutor",
                    "ProcessPoolExecutor"}
TEARDOWN_METHODS = {"join", "shutdown", "cancel"}


@dataclasses.dataclass
class GuardSpec:
    raw: str  # annotation text as written
    canonical: str | None  # resolved lock id; None = doc-only
    lineno: int


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    # field name -> kind ("lock"/"rlock"/"condition"/"event"/...)
    lock_fields: dict = dataclasses.field(default_factory=dict)
    # field name -> class name it holds (limited inference)
    field_types: dict = dataclasses.field(default_factory=dict)
    # field name -> canonical id of the lock it aliases
    aliases: dict = dataclasses.field(default_factory=dict)
    # field name -> GuardSpec
    guards: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    path: str
    modname: str
    lines: list
    tree: ast.AST
    classes: dict = dataclasses.field(default_factory=dict)
    # module-global name -> kind
    global_locks: dict = dataclasses.field(default_factory=dict)
    # module-global name -> GuardSpec
    global_guards: dict = dataclasses.field(default_factory=dict)


def _call_factory(node: ast.AST) -> str | None:
    """``threading.Lock()`` / ``Condition(RLock())`` / bare ``Lock()`` ->
    the factory's base name; None for anything else.  Conditional
    expressions (``X() if cond else param``) resolve through either arm."""
    if isinstance(node, ast.IfExp):
        return _call_factory(node.body) or _call_factory(node.orelse)
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None
    )
    return name


def _annotation_kind(ann: ast.AST) -> str | None:
    """Field kind from a type annotation (``threading.Lock``,
    ``threading.Lock | None``, ``Condition``)."""
    text = ast.unparse(ann)
    for factory, kind in FACTORY_KINDS.items():
        if re.search(rf"\b{factory}\b", text):
            return kind
    return None


def _guard_comments(lines: list) -> dict:
    """lineno -> guard text, attaching standalone-comment annotations to
    the next non-comment line."""
    out: dict[int, str] = {}
    pending: str | None = None
    for i, line in enumerate(lines, start=1):
        m = GUARD_RE.search(line)
        stripped = line.strip()
        if m:
            if stripped.startswith("#"):
                pending = m.group(1).strip()
                continue
            out[i] = m.group(1).strip()
            pending = None
        elif pending is not None and stripped and not stripped.startswith("#"):
            out[i] = pending
            pending = None
    return out


def _doc_only(guard: str) -> bool:
    return not IDENT_RE.match(guard)


class _ModuleScanner:
    """Pass 1: classes, lock fields, field types, aliases, guards."""

    def __init__(self, path: str, modname: str, source: str):
        self.info = ModuleInfo(
            path=path, modname=modname, lines=source.splitlines(),
            tree=ast.parse(source),
        )

    def scan(self) -> ModuleInfo:
        info = self.info
        guard_lines = _guard_comments(info.lines)
        for node in info.tree.body:
            if isinstance(node, ast.ClassDef):
                info.classes[node.name] = self._scan_class(node, guard_lines)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._scan_global(node, guard_lines)
        return info

    def _scan_global(self, node, guard_lines) -> None:
        info = self.info
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        factory = _call_factory(getattr(node, "value", None))
        kind = FACTORY_KINDS.get(factory) if factory else None
        for name in names:
            if kind:
                info.global_locks[name] = kind
            guard = guard_lines.get(node.lineno)
            if guard:
                info.global_guards[name] = GuardSpec(
                    guard, self._canon_guard(guard, None), node.lineno
                )

    def _scan_class(self, node: ast.ClassDef, guard_lines) -> ClassInfo:
        ci = ClassInfo(node.name, node)
        # dataclass-style annotated fields in the class body
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name):
                kind = _annotation_kind(stmt.annotation)
                if kind:
                    ci.lock_fields[stmt.target.id] = kind
                guard = guard_lines.get(stmt.lineno)
                if guard:
                    ci.guards[stmt.target.id] = GuardSpec(
                        guard, None, stmt.lineno)  # canonical filled below
        # __init__-style self.X assignments anywhere in the class
        for fn in [s for s in node.body if isinstance(s, ast.FunctionDef)]:
            params = {
                a.arg: ast.unparse(a.annotation)
                for a in fn.args.args
                if a.annotation is not None
            }
            for stmt in ast.walk(fn):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    field = t.attr
                    value = getattr(stmt, "value", None)
                    factory = _call_factory(value)
                    if factory in FACTORY_KINDS:
                        ci.lock_fields.setdefault(
                            field, FACTORY_KINDS[factory])
                    elif factory and factory[0].isupper():
                        # self.x = ClassName(...): remember the type
                        ci.field_types.setdefault(field, factory)
                    if isinstance(value, ast.Attribute) and isinstance(
                            value.value, ast.Name) and value.value.id == "self":
                        # self._lock = self.not_empty: alias
                        ci.aliases[field] = value.attr
                    if isinstance(value, ast.Name) and value.id in params:
                        # self.x = param  (annotated): remember the type,
                        # or the lock kind if the annotation is a lock type
                        ann = params[value.id]
                        kind = _annotation_kind(ast.parse(ann, mode="eval").body) \
                            if ann else None
                        if kind:
                            ci.lock_fields.setdefault(field, kind)
                        else:
                            m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", ann)
                            if m and m.group(0)[0].isupper():
                                ci.field_types.setdefault(field, m.group(0))
                    guard = guard_lines.get(stmt.lineno)
                    if guard and field not in ci.guards:
                        ci.guards[field] = GuardSpec(guard, None, stmt.lineno)
        return ci

    def _canon_guard(self, guard: str, cls: ClassInfo | None) -> str | None:
        if _doc_only(guard):
            return None
        if guard.startswith("self."):
            if cls is None:
                return None
            return canonical_attr(cls, guard[len("self."):], self.info)
        return f"{self.info.modname}:{guard}"


def canonical_attr(cls: ClassInfo, attr: str, info: ModuleInfo) -> str:
    """``ClassName.attr`` with same-class aliases resolved."""
    seen = set()
    while attr in cls.aliases and attr not in seen:
        seen.add(attr)
        attr = cls.aliases[attr]
    return f"{cls.name}.{attr}"


def finalize_guards(info: ModuleInfo) -> None:
    scanner_canon = _ModuleScanner.__dict__["_canon_guard"]
    shim = type("_S", (), {"info": info, "_canon_guard": scanner_canon})()
    for ci in info.classes.values():
        for field, spec in ci.guards.items():
            spec.canonical = shim._canon_guard(spec.raw, ci)
    for name, spec in info.global_guards.items():
        spec.canonical = shim._canon_guard(spec.raw, None)


# -- pass 2: per-function facts ---------------------------------------------

@dataclasses.dataclass
class MethodFacts:
    name: str
    cls: str | None
    # (owner_class_or_None, field, frozenset(held), lineno)
    mutations: list = dataclasses.field(default_factory=list)
    # (lock_id, frozenset(held_before), lineno)
    acquires: list = dataclasses.field(default_factory=list)
    # (callee_name, frozenset(held), lineno) — self.method() calls
    self_calls: list = dataclasses.field(default_factory=list)
    # (lock_id_or_None(kind unknown), receiver_kind, in_while, lineno)
    waits: list = dataclasses.field(default_factory=list)
    starts_threads: list = dataclasses.field(default_factory=list)  # linenos
    has_teardown: bool = False


class _FunctionWalker(ast.NodeVisitor):
    def __init__(self, info: ModuleInfo, cls: ClassInfo | None,
                 fn: ast.FunctionDef):
        self.info = info
        self.cls = cls
        self.fn = fn
        self.facts = MethodFacts(fn.name, cls.name if cls else None)
        self.held: frozenset = frozenset()
        self.while_depth = 0
        # local name -> class name (annotated params + simple aliases)
        self.local_types: dict[str, str] = {}
        # local name -> canonical lock id (lock aliases)
        self.local_locks: dict[str, str] = {}
        for a in fn.args.args:
            if a.annotation is not None:
                text = ast.unparse(a.annotation)
                m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", text)
                if m and m.group(0)[0].isupper():
                    self.local_types[a.arg] = m.group(0)

    # -- resolution --------------------------------------------------------
    def _type_of(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Name):
            return self.local_types.get(node.id)
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id == "self" and self.cls:
            return self.cls.field_types.get(node.attr)
        return None

    def _lock_id(self, node: ast.AST) -> tuple[str | None, str | None]:
        """Canonical lock id and kind for an expression, or (None, None)."""
        if isinstance(node, ast.Name):
            if node.id in self.local_locks:
                lock = self.local_locks[node.id]
                return lock, self._kind_of(lock)
            if node.id in self.info.global_locks:
                lock = f"{self.info.modname}:{node.id}"
                return lock, self.info.global_locks[node.id]
            return None, None
        if isinstance(node, ast.Attribute):
            owner: ClassInfo | None = None
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                owner = self.cls
            else:
                tname = self._type_of(node.value)
                owner = self.info.classes.get(tname) if tname else None
            if owner is not None and (
                    node.attr in owner.lock_fields
                    or node.attr in owner.aliases):
                lock = canonical_attr(owner, node.attr, self.info)
                return lock, self._kind_of(lock)
        return None, None

    def _kind_of(self, lock_id: str) -> str | None:
        if ":" in lock_id:
            return self.info.global_locks.get(lock_id.split(":", 1)[1])
        cls_name, _, attr = lock_id.partition(".")
        ci = self.info.classes.get(cls_name)
        return ci.lock_fields.get(attr) if ci else None

    def _field_owner(self, node: ast.AST) -> tuple[str | None, str | None]:
        """(owner class name, field) of a ``<recv>.field`` expression."""
        if not isinstance(node, ast.Attribute):
            return None, None
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return (self.cls.name if self.cls else None), node.attr
        tname = self._type_of(node.value)
        if tname and tname in self.info.classes:
            return tname, node.attr
        return None, None

    # -- walk --------------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        prev = self.held
        acquired = []
        for item in node.items:
            lock, kind = self._lock_id(item.context_expr)
            if lock is not None and (kind in LOCKY_KINDS or kind is None):
                self.facts.acquires.append((lock, self.held, node.lineno))
                acquired.append(lock)
                self.held = self.held | {lock}
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    def visit_While(self, node: ast.While) -> None:
        self.while_depth += 1
        self.generic_visit(node)
        self.while_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs run later, possibly on another thread: analyze with an
        # empty held set (their facts merge into this method's under a
        # closure marker so entry-held propagation never applies)
        sub = _FunctionWalker(self.info, self.cls, node)
        sub.local_types.update(self.local_types)
        sub.generic_visit(node)
        f = sub.facts
        self.facts.mutations += f.mutations
        self.facts.acquires += f.acquires
        self.facts.waits += f.waits
        self.facts.starts_threads += f.starts_threads
        self.facts.has_teardown |= f.has_teardown
        # self-calls from closures lose the caller's held set by design

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_store(t, node.lineno)
        # alias tracking: x = self._lock / sched = self.scheduler
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            lock, _ = self._lock_id(node.value)
            if lock is not None:
                self.local_locks[name] = lock
            tname = self._type_of(node.value)
            if tname is not None:
                self.local_types[name] = tname
            factory = _call_factory(node.value)
            if factory and factory[0].isupper() and \
                    factory in self.info.classes:
                self.local_types[name] = factory
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_store(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._record_store(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_store(t, node.lineno)
        self.generic_visit(node)

    def _record_store(self, target: ast.AST, lineno: int) -> None:
        # peel subscripts: self.d[k] = v mutates self.d
        while isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Attribute):
            owner, field = self._field_owner(target)
            if owner is not None:
                self.facts.mutations.append(
                    (owner, field, self.held, lineno))
        elif isinstance(target, ast.Name):
            if target.id in self.info.global_guards and \
                    self._declares_global(target.id):
                self.facts.mutations.append(
                    (None, target.id, self.held, lineno))

    def _declares_global(self, name: str) -> bool:
        return any(
            isinstance(s, ast.Global) and name in s.names
            for s in ast.walk(self.fn)
        )

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            # mutator method on a tracked field: self.d.update(...)
            if fn.attr in MUTATORS:
                owner, field = self._field_owner(recv)
                if owner is not None:
                    self.facts.mutations.append(
                        (owner, field, self.held, node.lineno))
                elif isinstance(recv, ast.Subscript):
                    inner = recv.value
                    owner, field = self._field_owner(inner)
                    if owner is not None:
                        self.facts.mutations.append(
                            (owner, field, self.held, node.lineno))
                elif isinstance(recv, ast.Name) and \
                        recv.id in self.info.global_guards:
                    self.facts.mutations.append(
                        (None, recv.id, self.held, node.lineno))
            if fn.attr == "wait":
                lock, kind = self._lock_id(recv)
                if kind == "condition":
                    self.facts.waits.append(
                        (lock, self.while_depth > 0, node.lineno))
            if fn.attr in TEARDOWN_METHODS:
                self.facts.has_teardown = True
            # self.method(...) call for interprocedural propagation
            if isinstance(recv, ast.Name) and recv.id == "self":
                self.facts.self_calls.append(
                    (fn.attr, self.held, node.lineno))
            # module-global dict item mutation: _CACHE[k] = handled in
            # _record_store; _CACHE.update(...) handled above via Name recv
        factory = _call_factory(node)
        if factory in THREAD_FACTORIES:
            self.facts.starts_threads.append(node.lineno)
        self.generic_visit(node)


# -- pass 3: interprocedural fixpoint + rule evaluation ---------------------

def _collect_facts(info: ModuleInfo) -> dict:
    """(class_or_None, method) -> MethodFacts for every function."""
    facts: dict = {}
    for node in info.tree.body:
        if isinstance(node, ast.ClassDef):
            ci = info.classes[node.name]
            for fn in [s for s in node.body
                       if isinstance(s, ast.FunctionDef)]:
                w = _FunctionWalker(info, ci, fn)
                for stmt in fn.body:
                    w.visit(stmt)
                facts[(node.name, fn.name)] = w.facts
        elif isinstance(node, ast.FunctionDef):
            w = _FunctionWalker(info, None, node)
            for stmt in node.body:
                w.visit(stmt)
            facts[(None, node.name)] = w.facts
    return facts


def _entry_held(facts: dict) -> dict:
    """Fixpoint: locks provably held at entry of every private method
    (intersection over all internal call sites; public methods: none)."""
    entry = {key: frozenset() for key in facts}
    for _ in range(len(facts) + 1):
        changed = False
        # gather call-site held sets per callee
        sites: dict = {}
        for (cls, _name), f in facts.items():
            for callee, held, _ln in f.self_calls:
                key = (cls, callee)
                if key in facts:
                    sites.setdefault(key, []).append(
                        held | entry[(cls, f.name)])
        for key, f in facts.items():
            cls, name = key
            if not name.startswith("_") or name.startswith("__"):
                continue  # public or dunder: callable with nothing held
            if key not in sites:
                continue
            new = frozenset.intersection(*map(frozenset, sites[key]))
            if new != entry[key]:
                entry[key] = new
                changed = True
        if not changed:
            break
    return entry


def _suppressed(info: ModuleInfo, lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(info.lines):
        m = ALLOW_RE.search(info.lines[lineno - 1])
        if m and m.group(1) == rule:
            return True
    return False


def _loc(info: ModuleInfo, lineno: int) -> str:
    return f"{info.path}:{lineno}"


def _known_lock(info: ModuleInfo, canonical: str | None) -> bool:
    if canonical is None:
        return False
    if ":" in canonical:
        return canonical.split(":", 1)[1] in info.global_locks
    cls_name, _, attr = canonical.partition(".")
    ci = info.classes.get(cls_name)
    return ci is not None and attr in ci.lock_fields


def lint_module(info: ModuleInfo, report: Report,
                lock_graph: dict, lock_kinds: dict) -> None:
    finalize_guards(info)
    all_guards = list(info.global_guards.values()) + [
        s for ci in info.classes.values() for s in ci.guards.values()
    ]
    report.stats["guarded_fields_checked"] = report.stats.get(
        "guarded_fields_checked", 0) + sum(
        1 for s in all_guards if _known_lock(info, s.canonical))
    report.stats["guarded_fields_doc_only"] = report.stats.get(
        "guarded_fields_doc_only", 0) + sum(
        1 for s in all_guards if _doc_only(s.raw))
    facts = _collect_facts(info)
    entry = _entry_held(facts)

    # guard lookup tables
    def guard_of(owner: str | None, field: str) -> GuardSpec | None:
        if owner is None:
            return info.global_guards.get(field)
        ci = info.classes.get(owner)
        return ci.guards.get(field) if ci else None

    for key, f in facts.items():
        cls, name = key
        eh = entry.get(key, frozenset())
        exempt = name in ("__init__", "__post_init__", "__new__")
        for owner, field, held, lineno in f.mutations:
            spec = guard_of(owner, field)
            if spec is None or exempt:
                continue
            if not _known_lock(info, spec.canonical):
                continue  # doc-only or unresolvable (reported once below)
            if spec.canonical not in (held | eh):
                if not _suppressed(info, lineno, "CONC-GUARD"):
                    report.add(
                        "CONC-GUARD", Severity.ERROR, _loc(info, lineno),
                        f"{owner + '.' if owner else ''}{field} is "
                        f"guarded-by {spec.raw!r} but mutated in "
                        f"{cls + '.' if cls else ''}{name} without holding "
                        f"it",
                    )
        for lock, held, lineno in f.acquires:
            for h in held | eh:
                lock_graph.setdefault(h, {}).setdefault(
                    lock, _loc(info, lineno))
            kind = None
            if ":" in lock:
                kind = info.global_locks.get(lock.split(":", 1)[1])
            else:
                c, _, a = lock.partition(".")
                ci = info.classes.get(c)
                kind = ci.lock_fields.get(a) if ci else None
            if kind:
                lock_kinds[lock] = kind
            if lock in (held | eh) and lock_kinds.get(lock) == "lock":
                if not _suppressed(info, lineno, "CONC-SELF-DEADLOCK"):
                    report.add(
                        "CONC-SELF-DEADLOCK", Severity.ERROR,
                        _loc(info, lineno),
                        f"non-reentrant lock {lock} re-acquired while "
                        f"already held in "
                        f"{cls + '.' if cls else ''}{name}",
                    )
        for lock, in_while, lineno in f.waits:
            if not in_while and not _suppressed(
                    info, lineno, "CONC-WAIT-LOOP"):
                report.add(
                    "CONC-WAIT-LOOP", Severity.WARNING, _loc(info, lineno),
                    f"Condition.wait on {lock or 'a condition'} outside a "
                    f"while predicate loop; condition wakeups are spurious",
                )

    # interprocedural lock-order edges through private self-calls: caller
    # holding L calls a method that acquires M -> edge L -> M
    acq_closure: dict = {
        key: {lock for lock, _h, _l in f.acquires}
        for key, f in facts.items()
    }
    for _ in range(len(facts) + 1):
        changed = False
        for key, f in facts.items():
            cls, _name = key
            for callee, _held, _ln in f.self_calls:
                ck = (cls, callee)
                if ck in acq_closure and not (
                        acq_closure[ck] <= acq_closure[key]):
                    acq_closure[key] |= acq_closure[ck]
                    changed = True
        if not changed:
            break
    for key, f in facts.items():
        cls, _name = key
        eh = entry.get(key, frozenset())
        for callee, held, lineno in f.self_calls:
            ck = (cls, callee)
            if ck not in acq_closure:
                continue
            for h in held | eh:
                for m in acq_closure[ck]:
                    lock_graph.setdefault(h, {}).setdefault(
                        m, _loc(info, lineno))
                    if h == m and lock_kinds.get(h) == "lock" and \
                            not _suppressed(info, lineno,
                                            "CONC-SELF-DEADLOCK"):
                        report.add(
                            "CONC-SELF-DEADLOCK", Severity.ERROR,
                            _loc(info, lineno),
                            f"non-reentrant lock {h} held across a call to "
                            f"self.{callee}() which re-acquires it",
                        )

    # thread lifecycle per class
    for cls_name, ci in info.classes.items():
        starts = []
        teardown = False
        for (c, _n), f in facts.items():
            if c != cls_name:
                continue
            starts += f.starts_threads
            teardown |= f.has_teardown
        if starts and not teardown:
            lineno = min(starts)
            if not _suppressed(info, lineno, "CONC-THREAD-LIFECYCLE"):
                report.add(
                    "CONC-THREAD-LIFECYCLE", Severity.WARNING,
                    _loc(info, lineno),
                    f"{cls_name} starts threads/executors but has no "
                    f"join/shutdown/cancel teardown path",
                )

    # unresolvable checked-style guards
    for ci in info.classes.values():
        for field, spec in ci.guards.items():
            if not _doc_only(spec.raw) and not _known_lock(
                    info, spec.canonical):
                if not _suppressed(info, spec.lineno, "CONC-GUARD-UNKNOWN"):
                    report.add(
                        "CONC-GUARD-UNKNOWN", Severity.WARNING,
                        _loc(info, spec.lineno),
                        f"guarded-by {spec.raw!r} on {ci.name}.{field} "
                        f"names no lock the lint can resolve",
                    )
    for name, spec in info.global_guards.items():
        if not _doc_only(spec.raw) and not _known_lock(info, spec.canonical):
            if not _suppressed(info, spec.lineno, "CONC-GUARD-UNKNOWN"):
                report.add(
                    "CONC-GUARD-UNKNOWN", Severity.WARNING,
                    _loc(info, spec.lineno),
                    f"guarded-by {spec.raw!r} on module global {name} "
                    f"names no lock the lint can resolve",
                )


def _find_cycles(graph: dict) -> list:
    """Simple cycles in the lock graph (DFS; self-edges excluded — they are
    CONC-SELF-DEADLOCK's job, and reentrant self-edges are legal)."""
    cycles = []
    seen_cycles = set()

    def dfs(node, path, on_path):
        for nxt in graph.get(node, {}):
            if nxt == node:
                continue
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles


DEFAULT_SCOPE = (
    "src/repro_torch/serving",
    "src/repro_torch/runtime",
    "src/repro_torch/kernels/native.py",
    "src/repro_torch/kernels/autotune.py",
)

# the checkout root: DEFAULT_SCOPE is relative to it, wherever the caller's
# working directory is
REPO_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))


def iter_python_files(paths: Iterable[str], root: str = ".") -> list:
    out = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append((full, p))
        else:
            for dirpath, _dirs, files in os.walk(full):
                for f in sorted(files):
                    if f.endswith(".py"):
                        fp = os.path.join(dirpath, f)
                        out.append((fp, os.path.relpath(fp, root)))
    return sorted(out, key=lambda t: t[1])


def run(paths: Iterable[str] | None = None, root: str | None = None) -> Report:
    """Lint every file in ``paths`` (default: the threaded layers), relative
    to ``root`` (default: the checkout this package lies in)."""
    root = REPO_ROOT if root is None else root
    report = Report()
    lock_graph: dict = {}
    lock_kinds: dict = {}
    files = iter_python_files(paths or DEFAULT_SCOPE, root)
    for full, rel in files:
        with open(full, "r", encoding="utf-8") as fh:
            source = fh.read()
        modname = os.path.splitext(os.path.basename(rel))[0]
        info = _ModuleScanner(rel, modname, source).scan()
        lint_module(info, report, lock_graph, lock_kinds)
    for cyc in _find_cycles(lock_graph):
        edges = " -> ".join(cyc)
        locs = [lock_graph[a].get(b, "?")
                for a, b in zip(cyc, cyc[1:])]
        report.add(
            "CONC-ORDER", Severity.ERROR, locs[0] if locs else "?",
            f"lock-acquisition-order cycle: {edges} "
            f"(edges at {', '.join(locs)})",
        )
    report.stats["concurrency_files"] = len(files)
    report.stats["lock_graph_edges"] = sum(
        len(v) for v in lock_graph.values())
    report.stats["locks_discovered"] = len(lock_kinds)
    return report
