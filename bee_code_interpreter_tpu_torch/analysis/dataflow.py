"""Intraprocedural CFG and reaching definitions over ``ast``: the
port's own copy of the engine of the JAX package's
``analysis/dataflow.py`` (its control-flow graph and its reaching-
definitions fixpoint), which ``analysis/torchlint.py`` asks "which
assignments can give this name its value here" to track tensors from
their producers to a host sync.

Left out of the copy: the ``async with`` lock scopes and await-path
queries (the asyncio concurrency lint's), and the name-origin resolution
and constant folding (the workload policy's). Design constraints kept:
never crash on valid Python (every construct has a conservative fallback),
stay intraprocedural (one function or the module body at a time), and
over-approximate paths (every statement in a ``try`` may reach every
handler; a ``finally`` body is duplicated for abrupt exits), so a
definition that reaches on some path is counted.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

#: Virtual exit node id: edges to EXIT mean "the function returns/raises out".
EXIT = -1

_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def iter_own_exprs(stmt: ast.stmt):
    """The expressions a statement itself evaluates, excluding the bodies
    of nested functions/lambdas and — for compound statements — excluding
    sub-statement bodies (those become their own CFG nodes). ``ClassDef``
    is a leaf in the CFG, so its whole body (minus nested functions)
    counts as its own region."""
    if isinstance(stmt, (ast.If, ast.While)):
        roots: list[ast.AST] = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.target, stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [item.context_expr for item in stmt.items]
        roots += [
            item.optional_vars
            for item in stmt.items
            if item.optional_vars is not None
        ]
    elif isinstance(stmt, ast.Try):
        roots = []
    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        roots = list(stmt.decorator_list)
    elif isinstance(stmt, ast.ClassDef):
        roots = list(stmt.decorator_list) + list(stmt.bases) + list(stmt.body)
    else:
        roots = [stmt]
    stack = list(roots)
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNCTION_NODES):
            continue
        if isinstance(node, ast.expr):
            yield node
        for child in ast.iter_child_nodes(node):
            stack.append(child)


def _assigned_names(stmt: ast.stmt) -> set[str]:
    """Plain names this statement (re)binds — the kill/gen set for
    reaching definitions. Attribute/subscript targets are not name
    bindings and are tracked separately by consumers."""
    names: set[str] = set()

    def targets(node: ast.expr) -> None:
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                targets(elt)
        elif isinstance(node, ast.Starred):
            targets(node.value)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            targets(t)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets(stmt.target)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                targets(item.optional_vars)
    elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
        for alias in stmt.names:
            names.add((alias.asname or alias.name).split(".", 1)[0])
    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        names.add(stmt.name)
    # walrus bindings inside the statement's own expressions
    for e in iter_own_exprs(stmt):
        if isinstance(e, ast.NamedExpr) and isinstance(e.target, ast.Name):
            names.add(e.target.id)
    return names


@dataclass
class StmtNode:
    """One flattened statement in the CFG."""

    idx: int
    stmt: ast.stmt
    succs: set[int] = field(default_factory=set)
    defines: set[str] = field(default_factory=set)


class FunctionFlow:
    """CFG + reaching definitions for ONE scope: a function body or the
    module body (``scope`` is the FunctionDef/AsyncFunctionDef/Module)."""

    def __init__(self, scope: ast.AST) -> None:
        self.scope = scope
        self.nodes: list[StmtNode] = []
        body = list(getattr(scope, "body", []))
        self._build_seq(body, EXIT, loops=[], finallies=[], exc=())
        self._preds: dict[int, set[int]] | None = None
        self._reach_in: list[dict[str, frozenset[int]]] | None = None

    # ------------------------------------------------------------ build
    def _new_node(self, stmt: ast.stmt) -> StmtNode:
        node = StmtNode(idx=len(self.nodes), stmt=stmt,
                        defines=_assigned_names(stmt))
        self.nodes.append(node)
        return node

    def _build_seq(
        self, stmts, succ, *, loops, finallies, exc
    ) -> int:
        """Flatten a statement sequence; returns the entry node idx (or
        ``succ`` for an empty sequence). Built by a reverse fold so each
        statement's successor is already known."""
        entry = succ
        for stmt in reversed(stmts):
            entry = self._build_stmt(
                stmt, entry, loops=loops, finallies=finallies, exc=exc
            )
        return entry

    def _abrupt_target(self, finallies) -> int:
        return finallies[-1] if finallies else EXIT

    def _build_stmt(self, stmt, succ, *, loops, finallies, exc) -> int:
        node = self._new_node(stmt)
        kw = dict(loops=loops, finallies=finallies, exc=exc)
        if isinstance(stmt, ast.If):
            body = self._build_seq(stmt.body, succ, **kw)
            orelse = self._build_seq(stmt.orelse, succ, **kw) if stmt.orelse else succ
            node.succs = {body, orelse}
        elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            orelse = self._build_seq(stmt.orelse, succ, **kw) if stmt.orelse else succ
            inner_loops = loops + [(succ, node.idx)]  # (break, continue)
            body = self._build_seq(
                stmt.body, node.idx,
                loops=inner_loops, finallies=finallies, exc=exc,
            )
            node.succs = {body, orelse}
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            body = self._build_seq(stmt.body, succ, **kw)
            node.succs = {body}
        elif isinstance(stmt, ast.Try):
            after = succ
            inner_finallies = finallies
            if stmt.finalbody:
                # Two copies of the finally body: one continuing normally,
                # one continuing the abrupt exit it is unwinding toward.
                after = self._build_seq(stmt.finalbody, succ, **kw)
                abrupt = self._build_seq(
                    stmt.finalbody, self._abrupt_target(finallies), **kw
                )
                inner_finallies = finallies + [abrupt]
            handler_entries = []
            for handler in stmt.handlers:
                handler_entries.append(
                    self._build_seq(
                        handler.body, after,
                        loops=loops, finallies=inner_finallies, exc=exc,
                    )
                )
            orelse = (
                self._build_seq(
                    stmt.orelse, after,
                    loops=loops, finallies=inner_finallies, exc=exc,
                )
                if stmt.orelse
                else after
            )
            inner_exc = tuple(handler_entries) or (
                (inner_finallies[-1],) if stmt.finalbody else exc
            )
            body = self._build_seq(
                stmt.body, orelse,
                loops=loops, finallies=inner_finallies, exc=inner_exc,
            )
            node.succs = {body}
        elif isinstance(stmt, (ast.Return, ast.Raise)):
            if isinstance(stmt, ast.Raise) and exc:
                node.succs = set(exc)
            else:
                node.succs = {self._abrupt_target(finallies)}
        elif isinstance(stmt, ast.Break):
            node.succs = {loops[-1][0]} if loops else {self._abrupt_target(finallies)}
        elif isinstance(stmt, ast.Continue):
            node.succs = {loops[-1][1]} if loops else {self._abrupt_target(finallies)}
        else:
            node.succs = {succ}
        # Any statement inside a try body may raise into the handlers —
        # the over-approximation that keeps "on all paths" rules honest.
        if exc and not isinstance(stmt, (ast.Return, ast.Break, ast.Continue)):
            node.succs |= set(exc)
        return node.idx

    # --------------------------------------------------- reaching defs
    def preds(self) -> dict[int, set[int]]:
        if self._preds is None:
            preds: dict[int, set[int]] = {n.idx: set() for n in self.nodes}
            for n in self.nodes:
                for s in n.succs:
                    if s != EXIT:
                        preds[s].add(n.idx)
            self._preds = preds
        return self._preds

    def reach_in(self, idx: int) -> dict[str, frozenset[int]]:
        """name → def-site node ids reaching the ENTRY of statement ``idx``."""
        if self._reach_in is None:
            self._compute_reaching()
        return self._reach_in[idx]

    def _compute_reaching(self) -> None:
        n = len(self.nodes)
        reach_in: list[dict[str, frozenset[int]]] = [{} for _ in range(n)]
        preds = self.preds()
        out: list[dict[str, frozenset[int]]] = [{} for _ in range(n)]

        def transfer(idx: int, in_map):
            node = self.nodes[idx]
            if not node.defines:
                return in_map
            new = dict(in_map)
            for name in node.defines:
                new[name] = frozenset((idx,))
            return new

        # Source order first (nodes are created roughly in source order):
        # forward dataflow over a mostly-reducible CFG then converges in
        # one or two sweeps instead of thrashing backwards.
        worklist = list(range(n - 1, -1, -1))
        while worklist:
            idx = worklist.pop()
            merged: dict[str, frozenset[int]] = {}
            for p in preds[idx]:
                for name, defs in out[p].items():
                    if name in merged:
                        merged[name] = merged[name] | defs
                    else:
                        merged[name] = defs
            if merged != reach_in[idx]:
                reach_in[idx] = merged
            new_out = transfer(idx, merged)
            if new_out != out[idx]:
                out[idx] = new_out
                for s in self.nodes[idx].succs:
                    if s != EXIT:
                        worklist.append(s)
        self._reach_in = reach_in
