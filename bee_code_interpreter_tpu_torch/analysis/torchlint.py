"""Torch-aware static lint of the port package: the counterpart of the JAX
package's ``analysis/jaxlint.py`` (tests/test_torch_lint.py holds it).

Its invariants are the ones that cost the card throughput rather than
correctness: a decode loop that waits for the device per token, a
``torch.compile`` or CUDA graph rebuilt per call, a step that copies its
whole state, a Python branch on a tensor's value (a hidden sync, and a
break in any CUDA-graph capture), a collective over an axis no mesh binds.
The suppression contract is jaxlint's: every sanctioned site carries a
justification, and a suppression no finding matches fails.

Rules:

- ``host-sync-in-hot-loop``: inside a loop, or anywhere in a method
  reachable from a class's ``step()`` (everything ``step`` calls runs per
  decode step), a device -> host wait: ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, ``<event or stream>.synchronize()``;
  ``.item()`` / ``.tolist()`` on, and ``float()`` / ``int()`` / ``bool()``
  / ``np.asarray`` / ``np.array`` of, a value the dataflow tracks to a
  torch producer, a kernel wrapper of ``ops/`` or a compiled program
  (``TrackedJit``, ``torch.compile``).
- ``compile-in-loop``: ``torch.compile``, ``torch.cuda.CUDAGraph``,
  ``torch.cuda.graph`` or ``torch.cuda.make_graphed_callables`` built in a
  loop body: each iteration compiles or captures anew.
- ``recompile-hazard``: ``torch.compile(f)(...)`` called at once (its
  cache dies with the statement), a compiled program built and called in
  the same function body (rebuilt per call), or compile options
  (``mode``, ``dynamic``, ``fullgraph``, ``backend``, ``options``) that are
  not constants.
- ``state-copy-per-step``: a compiled function, or a method on a class's
  step path, that returns a fresh copy (``.clone()``, ``torch.clone``,
  ``copy.deepcopy``) of a state argument it was passed: every step pays a
  copy of the state it threads (the eager counterpart of an undonated
  state-in/state-out jit). Update in place and return the argument.
- ``tensor-python-branch``: an ``if`` / ``while`` on a tensor's value in a
  compiled function (on an argument without a default or a Python-scalar
  annotation: ``torch.compile`` specializes ``int``/``float``/``bool``/
  ``str``), or, in a step-path method or a loop, on a value the dataflow
  tracks to a tensor. Shape, dtype, device, ``len()``, ``size()``,
  ``dim()``, ``numel()`` and ``is None`` tests are static.
- ``collective-group-mismatch``: a ``parallel/mesh.py`` helper
  (``axis_size``, ``axis_index``), ``DeviceMesh.get_group`` or a
  ``torch.distributed`` collective's ``group`` named by a literal axis
  that no mesh binds (the file's ``make_mesh`` / ``init_device_mesh`` /
  ``DeviceMesh`` axes, a parameter's string default, or the axes every
  port mesh may have, ``parallel/mesh.py::TRAINING_AXES``), or by a name
  that is neither a literal nor an enclosing function's parameter.

Paths over-approximate and values under-approximate, as in the engine
underneath (``analysis/dataflow.py``): a finding is a real shape in the
code, and the suppression list records why a real shape is sanctioned.
"""

from __future__ import annotations

import ast
import dataclasses
import textwrap
from dataclasses import dataclass, field
from pathlib import Path

from bee_code_interpreter_tpu_torch.analysis.dataflow import (
    FunctionFlow,
    iter_own_exprs,
)
from bee_code_interpreter_tpu_torch.analysis.inspect import (
    collect_aliases,
    resolve_call_name,
)
from bee_code_interpreter_tpu_torch.analysis.suppressions import (
    Suppression,
    Violation,
)

#: The port package: every module of it is in scope, runtime/ included.
PACKAGE_ROOT = Path(__file__).resolve().parent.parent

#: The axes a port mesh may have (``parallel/mesh.py::TRAINING_AXES``,
#: which ``mesh_groups`` checks every mesh against): a literal among them
#: names an axis some mesh binds.
MESH_AXES = frozenset({"dp", "fsdp", "tp", "sp", "ep", "pp"})

_COMPILERS = frozenset({"torch.compile"})
_GRAPH_BUILDERS = frozenset({
    "torch.cuda.CUDAGraph", "torch.cuda.graph",
    "torch.cuda.make_graphed_callables",
})
#: Wrappers whose result is a compiled device program: calling it yields
#: tensors.
_PROGRAMS = frozenset({
    "torch.compile",
    "bee_code_interpreter_tpu_torch.utils.jitwatch.TrackedJit",
})
_COMPILE_OPTIONS = frozenset({"mode", "dynamic", "fullgraph", "backend",
                              "options"})
#: torch calls that make no tensor (or make host objects around one).
_NOT_PRODUCERS = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.utils.",
    "torch.profiler.", "torch.autograd.", "torch.device", "torch.dtype",
    "torch.Generator", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.set_", "torch.get_", "torch.is_",
    "torch.manual_seed", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.compile", "torch.nn.Module", "torch.optim.",
)
_PRODUCER_PREFIXES = ("torch.", "bee_code_interpreter_tpu_torch.ops.")
#: host-materializing calls of a tracked tensor
_VALUE_SINKS = frozenset({"float", "int", "bool", "numpy.asarray",
                          "numpy.array"})
#: methods that wait for the device whatever they are called on
_ALWAYS_SYNC = frozenset({"cpu", "numpy", "synchronize"})
#: methods that wait for the device when called on a tracked tensor
_TRACKED_SYNC = frozenset({"item", "tolist"})
#: attributes and methods that read static metadata, not a tensor's value
_STATIC_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                           "requires_grad", "layout"})
_STATIC_METHODS = frozenset({"size", "dim", "numel", "stride", "data_ptr",
                             "element_size", "is_contiguous", "is_floating_point"})
#: methods whose result is a host value, not a tensor
_HOST_RESULTS = frozenset({"item", "tolist", "numpy"}) | _STATIC_METHODS
_CLONES = frozenset({"torch.clone", "copy.deepcopy", "copy.copy"})
_SCALAR_ANNOTATIONS = frozenset({"int", "float", "bool", "str"})

#: helper name (the last part of the dotted name) -> positional index of
#: its axis argument
_AXIS_HELPERS: dict[str, int] = {"axis_size": 1, "axis_index": 1,
                                 "get_group": 0}
_AXIS_PARAMS = frozenset({"axis", "axis_name", "mesh_dim"})

#: Identifier tokens whose absence proves a file cannot contain anything
#: this lint flags (one token walk, no CFG).
TRIGGER_NAMES = frozenset({"torch", "TrackedJit", "axis_size", "axis_index",
                           "get_group"})
_TRIGGER_MODULES = ("torch", "bee_code_interpreter_tpu_torch")


# The shipped suppression budget: every entry says why the flagged shape is
# sound; one that matches no finding fails tests/test_torch_lint.py.
SUPPRESSIONS: tuple[Suppression, ...] = (
    Suppression(
        path="models/serving.py",
        rule="host-sync-in-hot-loop",
        reason=(
            "the batcher's step-path transfers are the designed device/host "
            "split of JAX's batcher (its own suppression for this file): one "
            "bounded pull per decode step, greedy tokens reduced on the card "
            "to [B] before crossing, whole logits rows only when a row samples "
            "on the host or records logprobs, one [B, gamma + 1] pull a "
            "speculative round, and per-window (page-aligned) pulls on the "
            "admission paths, and a sampled draft's logits rows once per "
            "draft step; host-side sampling keeps per-request "
            "heterogeneity out of the fixed-shape device program"
        ),
    ),
    Suppression(
        path="models/speculative.py",
        rule="host-sync-in-hot-loop",
        reason=(
            "speculative_generate reads the accepted run length once per "
            "round of gamma + 1 tokens: the next round's position and the "
            "commit's slice widths are host integers in eager PyTorch, where "
            "JAX runs the same loop as one lax.while_loop on the device"
        ),
    ),
)


@dataclass
class TorchLintReport:
    violations: list[Violation] = field(default_factory=list)
    suppressed: list[tuple[Violation, Suppression]] = field(default_factory=list)
    stale_suppressions: list[Suppression] = field(default_factory=list)
    files_scanned: int = 0

    def summary(self) -> str:
        lines = [str(v) for v in self.violations]
        lines += [
            f"stale suppression ({s.path} [{s.rule}]): no matching violation"
            for s in self.stale_suppressions
        ]
        return "\n".join(lines) or "clean"


def has_torch_triggers(tree: ast.AST) -> bool:
    """Cheap pre-scan: can this file contain a shape the lint flags? An
    import of torch or of the port, or a trigger identifier."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in TRIGGER_NAMES:
            return True
        if isinstance(node, ast.Import) and any(
                a.name.split(".", 1)[0] in _TRIGGER_MODULES for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and (node.module or "").split(
                ".", 1)[0] in _TRIGGER_MODULES:
            return True
    return False


def _own_calls(stmt: ast.stmt):
    """The calls a statement evaluates itself (``dataflow.iter_own_exprs``'
    region), lambda bodies included: a lambda runs where it is written (a
    sort key, a callback), so its calls belong to this statement."""
    for expr in iter_own_exprs(stmt):
        if isinstance(expr, ast.Call):
            yield expr
        kids = list(ast.iter_child_nodes(expr))
        kids += [k.value for k in kids if isinstance(k, ast.keyword)]
        for child in kids:
            if isinstance(child, ast.Lambda):
                yield from (n for n in ast.walk(child.body)
                            if isinstance(n, ast.Call))


# --------------------------------------------------------------------------
# facts about one file
# --------------------------------------------------------------------------


@dataclass
class _FunctionFacts:
    node: ast.AST
    params: tuple[str, ...]


def _function_params(func: ast.AST) -> tuple[str, ...]:
    args = func.args
    return tuple(a.arg for a in (*args.posonlyargs, *args.args)
                 if a.arg != "self")


def _collect_functions(tree: ast.AST) -> dict[str, _FunctionFacts]:
    """Every FunctionDef keyed by bare name (innermost wins on collision)."""
    return {node.name: _FunctionFacts(node, _function_params(node))
            for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _is_constant(expr: ast.expr) -> bool:
    """A compile-time constant: a literal, or a tuple/list/dict of them."""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_is_constant(e) for e in expr.elts)
    if isinstance(expr, ast.Dict):
        return all(k is not None and _is_constant(k) and _is_constant(v)
                   for k, v in zip(expr.keys, expr.values))
    return False


@dataclass
class _CompileSite:
    """One ``torch.compile(...)`` call, decomposed."""

    call: ast.Call
    target_name: str | None  # bare name of the compiled function
    partial_kwargs: frozenset[str]  # kwargs bound by functools.partial
    options_constant: bool


def _decompose_compile(call: ast.Call, aliases) -> _CompileSite | None:
    if resolve_call_name(call.func, aliases) not in _COMPILERS:
        return None
    target = call.args[0] if call.args else None
    partial_kwargs: set[str] = set()
    if isinstance(target, ast.Call) and resolve_call_name(
            target.func, aliases) in ("functools.partial", "partial"):
        partial_kwargs = {kw.arg for kw in target.keywords if kw.arg}
        target = target.args[0] if target.args else None
    return _CompileSite(
        call=call,
        target_name=target.id if isinstance(target, ast.Name) else None,
        partial_kwargs=frozenset(partial_kwargs),
        options_constant=all(_is_constant(kw.value) for kw in call.keywords
                             if kw.arg in _COMPILE_OPTIONS),
    )


_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_scope(node: ast.AST):
    """This scope's own nodes, not descending into nested defs/lambdas."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _FUNCTIONS):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _contexts(tree: ast.AST) -> dict[int, tuple[bool, tuple[ast.AST, ...]]]:
    """id(node) -> (lexically inside a loop?, enclosing-function chain,
    outermost first) for every call and every if/while statement. The loop
    context resets at a def (its body runs when called) and is inherited
    by a lambda (sort keys, callbacks run where they are written); a
    comprehension's first iterable evaluates once, outside the loop."""
    out: dict[int, tuple[bool, tuple[ast.AST, ...]]] = {}
    stack: list[tuple[ast.AST, bool, tuple]] = [(tree, False, ())]
    while stack:
        node, in_loop, funcs = stack.pop()
        if isinstance(node, (ast.Call, ast.If, ast.While)):
            out[id(node)] = (in_loop, funcs)
        if isinstance(node, _FUNCTIONS):
            inner = (*funcs, node)
            body_loop = in_loop if isinstance(node, ast.Lambda) else False
            for child in ast.iter_child_nodes(node):
                stack.append((child, body_loop, inner))
            continue
        if isinstance(node, _LOOP_NODES):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                stack.append((node.iter, in_loop, funcs))
                stack.append((node.target, in_loop, funcs))
            else:  # a while's test runs every iteration
                out[id(node)] = (True, funcs)
                stack.append((node.test, True, funcs))
            for child in node.orelse:
                stack.append((child, in_loop, funcs))
            for child in node.body:
                stack.append((child, True, funcs))
            continue
        if isinstance(node, _COMPREHENSIONS):
            for i, gen in enumerate(node.generators):
                stack.append((gen.iter, in_loop if i == 0 else True, funcs))
                for cond in gen.ifs:
                    stack.append((cond, True, funcs))
            if isinstance(node, ast.DictComp):
                stack.append((node.key, True, funcs))
                stack.append((node.value, True, funcs))
            else:
                stack.append((node.elt, True, funcs))
            continue
        for child in ast.iter_child_nodes(node):
            stack.append((child, in_loop, funcs))
    return out


#: Method names that seed a class's hot path: every serving loop calls
#: ``step`` per decode step, so everything it reaches is per-token work.
HOT_SEEDS = frozenset({"step"})


def _hot_methods(cls: ast.ClassDef) -> dict[str, ast.AST]:
    """Methods reachable from the class's HOT_SEEDS via ``self.m(...)``."""
    methods = {m.name: m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    edges: dict[str, set[str]] = {}
    for name, func in methods.items():
        edges[name] = {
            node.func.attr for node in ast.walk(func)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self" and node.func.attr in methods}
    hot: set[str] = set()
    frontier = [m for m in methods if m in HOT_SEEDS]
    while frontier:
        name = frontier.pop()
        if name not in hot:
            hot.add(name)
            frontier.extend(edges.get(name, ()))
    return {name: methods[name] for name in hot}


def _program_attrs(cls: ast.ClassDef, aliases) -> set[str]:
    """Attributes any method binds to a compiled program (``self._decode =
    TrackedJit(...)``), ``self.X = self.Y`` aliases followed to a fixpoint."""
    out: set[str] = set()
    pairs: list[tuple[str, str]] = []
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.attr for t in node.targets
                   if isinstance(t, ast.Attribute)
                   and isinstance(t.value, ast.Name) and t.value.id == "self"]
        if not targets:
            continue
        if isinstance(node.value, ast.Call) and resolve_call_name(
                node.value.func, aliases) in _PROGRAMS:
            out.update(targets)
        elif (isinstance(node.value, ast.Attribute)
              and isinstance(node.value.value, ast.Name)
              and node.value.value.id == "self"):
            pairs.extend((t, node.value.attr) for t in targets)
    changed = True
    while changed:
        changed = False
        for target, source in pairs:
            if source in out and target not in out:
                out.add(target)
                changed = True
    return out


def _bound_axes(tree: ast.AST, aliases) -> set[str]:
    """Axis names a mesh in this file binds: the keys of ``make_mesh``'s
    axes dict, the strings of ``init_device_mesh`` / ``DeviceMesh``
    ``mesh_dim_names``, and the string defaults of axis parameters."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            leaf = (resolve_call_name(node.func, aliases) or "").rsplit(".", 1)[-1]
            if leaf in ("make_mesh", "auto_mesh") and node.args and isinstance(
                    node.args[0], ast.Dict):
                out.update(k.value for k in node.args[0].keys
                           if isinstance(k, ast.Constant)
                           and isinstance(k.value, str))
            if leaf in ("init_device_mesh", "DeviceMesh"):
                for kw in node.keywords:
                    if kw.arg == "mesh_dim_names":
                        out.update(sub.value for sub in ast.walk(kw.value)
                                   if isinstance(sub, ast.Constant)
                                   and isinstance(sub.value, str))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            named = [*args.posonlyargs, *args.args, *args.kwonlyargs]
            defaults = [*args.defaults, *args.kw_defaults]
            for a, d in zip(reversed(named), reversed(defaults)):
                if (a.arg in _AXIS_PARAMS and isinstance(d, ast.Constant)
                        and isinstance(d.value, str)):
                    out.add(d.value)
    return out


def _enclosing_params(funcs) -> set[str]:
    """The names an enclosing function's parameters supply: the parameters
    themselves, and the targets of a ``for`` or comprehension over one of
    them (``for dim, axis in enumerate(spec)``) or over the mesh's own axes
    (``for a in axis_sizes(mesh)``, ``mesh.mesh_dim_names``)."""
    params: set[str] = set()
    for func in funcs:
        args = getattr(func, "args", None)
        if args is not None:
            params.update(a.arg for a in (*args.posonlyargs, *args.args,
                                          *args.kwonlyargs))
    out = set(params)
    for func in funcs:
        for node in ast.walk(func):
            loops = ([node] if isinstance(node, (ast.For, ast.AsyncFor))
                     else getattr(node, "generators", []))
            for loop in loops:
                reads = {n.id for n in ast.walk(loop.iter)
                         if isinstance(n, ast.Name)}
                mesh_axes = any(
                    isinstance(n, ast.Attribute) and n.attr == "mesh_dim_names"
                    or isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "axis_sizes" for n in ast.walk(loop.iter))
                if reads & params or mesh_axes:
                    out.update(n.id for n in ast.walk(loop.target)
                               if isinstance(n, ast.Name))
    return out


def _traced_params(func: ast.AST) -> frozenset[str]:
    """Positional params without a default and without a Python-scalar
    annotation: what a compiled call receives as tensors."""
    args = func.args
    named = [*args.posonlyargs, *args.args]
    first_default = len(named) - len(args.defaults)
    return frozenset(
        a.arg for a in named[:first_default]
        if a.arg != "self" and not (isinstance(a.annotation, ast.Name)
                                    and a.annotation.id in _SCALAR_ANNOTATIONS))


def _reads_value(test: ast.expr, is_tensor) -> bool:
    """Does a branch test read a tensor's VALUE (``is_tensor(name_node)``),
    as opposed to its static metadata or its identity?"""
    def walk(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("len", "isinstance"):
                return False
            if isinstance(f, ast.Attribute) and f.attr in _STATIC_METHODS:
                return False
        if isinstance(node, ast.Name) and is_tensor(node):
            return True
        return any(walk(child) for child in ast.iter_child_nodes(node))

    return walk(test)


def _clone_of_param(expr: ast.expr, params: frozenset[str], aliases) -> str | None:
    """The parameter ``expr`` returns a fresh copy of (``p.clone()``,
    ``p.detach().clone()``, ``torch.clone(p)``, ``copy.deepcopy(p)``)."""
    if not isinstance(expr, ast.Call):
        return None
    if isinstance(expr.func, ast.Attribute) and expr.func.attr == "clone":
        root = expr.func.value
        while isinstance(root, ast.Call) and isinstance(root.func, ast.Attribute):
            root = root.func.value
        return root.id if isinstance(root, ast.Name) and root.id in params else None
    if resolve_call_name(expr.func, aliases) in _CLONES and expr.args:
        arg = expr.args[0]
        return arg.id if isinstance(arg, ast.Name) and arg.id in params else None
    return None


class _Values:
    """Which expressions of one scope hold tensors: names whose reaching
    definitions (``analysis/dataflow.py``) come from a torch producer, a
    kernel wrapper of ``ops/`` or a compiled program, possibly through a
    chain of tensor methods and indexing."""

    def __init__(self, scope: ast.AST, aliases, program_attrs: set[str],
                 programs: set[str]) -> None:
        self.flow = FunctionFlow(scope)
        self.aliases = aliases
        self.program_attrs = program_attrs
        self.programs = programs

    def producer(self, call: ast.Call) -> bool:
        name = resolve_call_name(call.func, self.aliases)
        if name is not None:
            if name.startswith(_PRODUCER_PREFIXES) and not name.startswith(
                    _NOT_PRODUCERS):
                return True
            if "." not in name and name in self.programs:
                return True
        f = call.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and f.attr in self.program_attrs):
            return True
        return isinstance(f, ast.Call) and resolve_call_name(
            f.func, self.aliases) in _PROGRAMS

    def tensor(self, expr: ast.expr, at: int | None, depth: int = 0) -> bool:
        """Is ``expr``, evaluated at statement ``at``, rooted in a tensor?"""
        node = expr
        while True:
            if isinstance(node, ast.Attribute):
                if node.attr in _STATIC_ATTRS:
                    return False
                node = node.value
            elif isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if self.producer(node):
                    return True
                if node.func.attr in _HOST_RESULTS:
                    return False
                node = node.func.value  # a tensor's method gives a tensor
            else:
                break
        if isinstance(node, ast.Call):
            return self.producer(node)
        if isinstance(node, (ast.BinOp, ast.Compare, ast.UnaryOp, ast.BoolOp)):
            # arithmetic and comparisons of a tensor are tensors
            parts = [n for n in ast.iter_child_nodes(node)
                     if isinstance(n, ast.expr)]
            return any(self.tensor(n, at, depth + 1) for n in parts)
        if not isinstance(node, ast.Name) or at is None or depth > 6:
            return False
        for d in self.flow.reach_in(at).get(node.id, ()):
            value = _bound_value(self.flow.nodes[d].stmt, node.id)
            if value is not None and self.tensor(value, d, depth + 1):
                return True
        return False


def _bound_value(stmt: ast.stmt, name: str) -> ast.expr | None:
    """The right-hand side that binds ``name`` at this statement: a plain
    or annotated assignment, or an unpacking (every name unpacked from a
    tensor-producing call holds a tensor)."""
    def binds(target) -> bool:
        if isinstance(target, ast.Name):
            return target.id == name
        if isinstance(target, (ast.Tuple, ast.List)):
            return any(binds(e) for e in target.elts)
        if isinstance(target, ast.Starred):
            return binds(target.value)
        return False

    if isinstance(stmt, ast.Assign) and any(binds(t) for t in stmt.targets):
        return stmt.value
    if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) and binds(stmt.target):
        return stmt.value
    return None


# --------------------------------------------------------------------------
# the per-file walk
# --------------------------------------------------------------------------


class _FileLint:
    def __init__(self, tree: ast.Module, path: str,
                 corpus: "_CorpusFacts | None" = None) -> None:
        self.tree, self.path, self.corpus = tree, path, corpus
        self.aliases = collect_aliases(tree)
        self.violations: list[Violation] = []
        self.functions = _collect_functions(tree)
        self.contexts = _contexts(tree)
        self.bound_axes = _bound_axes(tree, self.aliases) | MESH_AXES
        self.programs = {
            t.id for node in ast.walk(tree)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
            and resolve_call_name(node.value.func, self.aliases) in _PROGRAMS
            for t in node.targets if isinstance(t, ast.Name)}
        self.program_attrs: dict[int, set[str]] = {}
        self.hot: set[int] = set()
        self.func_class: dict[int, ast.ClassDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.program_attrs[id(node)] = _program_attrs(node, self.aliases)
                self.hot.update(id(m) for m in _hot_methods(node).values())
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.func_class[id(m)] = node
        self.compile_sites = [
            site for node in ast.walk(tree) if isinstance(node, ast.Call)
            and (site := _decompose_compile(node, self.aliases)) is not None]

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.violations.append(Violation(
            path=self.path, line=getattr(node, "lineno", 0), rule=rule,
            message=message))

    def run(self) -> list[Violation]:
        self._check_compiles()
        self._check_state_copies()
        self._check_collectives()
        self._check_scopes()
        self.violations.sort(key=lambda v: (v.path, v.line, v.rule))
        return self.violations

    # ----------------------------------------------- compile / recompile
    def _check_compiles(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(node.func, self.aliases)
            if name in _COMPILERS | _GRAPH_BUILDERS and self.contexts.get(
                    id(node), (False, ()))[0]:
                self._flag(node, "compile-in-loop",
                           f"{name} inside a loop: every iteration compiles "
                           "or captures anew, with an empty cache: build it "
                           "once, outside the loop")
            if isinstance(node.func, ast.Call) and resolve_call_name(
                    node.func.func, self.aliases) in _COMPILERS:
                self._flag(node, "recompile-hazard",
                           "torch.compile(f)(...) called at once: the "
                           "compiled program dies with the statement: bind "
                           "it once and reuse it")
        for site in self.compile_sites:
            if not site.options_constant:
                self._flag(site.call, "recompile-hazard",
                           "torch.compile options are not constants: each "
                           "new value compiles anew")
        for func in ast.walk(self.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            built: dict[str, int] = {}
            returned: set[str] = set()
            called: set[str] = set()
            for inner in _walk_scope(func):
                if isinstance(inner, ast.Assign) and isinstance(
                        inner.value, ast.Call) and resolve_call_name(
                        inner.value.func, self.aliases) in _COMPILERS:
                    built.update((t.id, inner.lineno) for t in inner.targets
                                 if isinstance(t, ast.Name))
                elif isinstance(inner, ast.Return) and inner.value is not None:
                    elts = (inner.value.elts if isinstance(inner.value, ast.Tuple)
                            else [inner.value])
                    returned.update(e.id for e in elts if isinstance(e, ast.Name))
                elif isinstance(inner, ast.Call) and isinstance(inner.func, ast.Name):
                    called.add(inner.func.id)
            for name, line in built.items():
                if name in called and name not in returned:
                    self._flag(ast.copy_location(ast.Pass(), func),
                               "recompile-hazard",
                               f"torch.compile bound to `{name}` (line {line}) "
                               f"is built and called inside {func.name}(): "
                               f"each call of {func.name} compiles anew: build "
                               "once (module level, __init__, or a returned "
                               "factory)")

    # ------------------------------------------------------ state copies
    def _compiled_targets(self):
        """(function facts, partial-bound kwargs) of every compile site
        whose target is defined in this file (own sites, and sites in other
        files routed here by the corpus)."""
        sites = list(self.compile_sites)
        if self.corpus is not None:
            sites += self.corpus.foreign_sites.get(self.path, [])
        seen: set[int] = set()
        for site in sites:
            facts = (self.functions.get(site.target_name)
                     if site.target_name else None)
            if facts is not None and id(facts.node) not in seen:
                seen.add(id(facts.node))
                yield facts, site

    def _check_state_copies(self) -> None:
        funcs = [(facts.node, frozenset(facts.params) - site.partial_kwargs)
                 for facts, site in self._compiled_targets()]
        funcs += [(node, frozenset(_function_params(node)))
                  for node in ast.walk(self.tree)
                  if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and id(node) in self.hot]
        for func, params in funcs:
            for node in _walk_scope(func):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                elts = (node.value.elts if isinstance(node.value, ast.Tuple)
                        else [node.value])
                for e in elts:
                    param = _clone_of_param(e, params, self.aliases)
                    if param is not None:
                        self._flag(node, "state-copy-per-step",
                                   f"`{func.name}` returns a fresh copy of its "
                                   f"state argument `{param}`: every step pays "
                                   "a copy of the state it threads: update it "
                                   "in place and return the argument")

    # ------------------------------------------------------- collectives
    def _check_collectives(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve_call_name(node.func, self.aliases) or (
                f".{node.func.attr}" if isinstance(node.func, ast.Attribute)
                else "")
            index = _AXIS_HELPERS.get(name.rsplit(".", 1)[-1])
            axes: list[ast.expr] = []
            if index is not None:
                kw = next((k.value for k in node.keywords
                           if k.arg in _AXIS_PARAMS), None)
                if kw is not None:
                    axes = [kw]
                elif len(node.args) > index:
                    axes = [node.args[index]]
            elif name.startswith("torch.distributed."):
                for kw in node.keywords:
                    if kw.arg == "group" and isinstance(kw.value, (ast.Constant,
                                                                    ast.Tuple)):
                        axes = [e for e in ast.walk(kw.value)
                                if isinstance(e, ast.Constant)]
            leaf = name.rsplit(".", 1)[-1]
            for axis in axes:
                if isinstance(axis, ast.Constant) and isinstance(axis.value, str):
                    if axis.value not in self.bound_axes:
                        self._flag(node, "collective-group-mismatch",
                                   f"{leaf} over axis {axis.value!r}, which no "
                                   "mesh binds (this file's make_mesh / "
                                   "init_device_mesh, a parameter default, or "
                                   "the port's mesh axes): it can only fail at "
                                   "run time")
                elif isinstance(axis, ast.Name):
                    _, funcs = self.contexts.get(id(node), (False, ()))
                    if axis.id not in _enclosing_params(funcs):
                        self._flag(node, "collective-group-mismatch",
                                   f"{leaf} axis `{axis.id}` is neither a "
                                   "literal a mesh binds nor a parameter of "
                                   "an enclosing function: the axis cannot be "
                                   "audited")

    # ------------------------------------- host syncs and tensor branches
    def _check_scopes(self) -> None:
        compiled = {id(facts.node): _traced_params(facts.node) - site.partial_kwargs
                    for facts, site in self._compiled_targets()}
        scopes = [self.tree] + [n for n in ast.walk(self.tree)
                                if isinstance(n, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef))]
        for scope in scopes:
            cls = self.func_class.get(id(scope))
            values = _Values(scope, self.aliases,
                             self.program_attrs.get(id(cls), set()) if cls
                             else set(), self.programs)
            hot_method = id(scope) in self.hot
            for node in values.flow.nodes:
                for call in _own_calls(node.stmt):
                    self._check_call(call, node.idx, scope, values, hot_method)
            traced = compiled.get(id(scope), frozenset())
            for node in values.flow.nodes:
                stmt = node.stmt
                if not isinstance(stmt, (ast.If, ast.While)):
                    continue
                kind = "while" if isinstance(stmt, ast.While) else "if"
                if traced and _reads_value(
                        stmt.test, lambda n: n.id in traced):
                    self._flag(stmt, "tensor-python-branch",
                               f"Python `{kind}` on a tensor argument's value "
                               f"in compiled `{scope.name}`: a graph break and "
                               "a host sync: use torch.where, or pass a "
                               "Python scalar")
                    continue
                in_loop = self.contexts.get(id(stmt), (False, ()))[0]
                if (in_loop or hot_method) and _reads_value(
                        stmt.test, lambda n: values.tensor(n, node.idx)):
                    where = ("inside a loop" if in_loop else
                             f"on the step path (via {scope.name})")
                    self._flag(stmt, "tensor-python-branch",
                               f"Python `{kind}` on a tensor's value {where}: "
                               "a hidden device -> host sync per iteration, "
                               "and a break in any CUDA-graph capture: keep "
                               "the decision on the card (torch.where) or "
                               "on host state")

    def _check_call(self, call: ast.Call, at: int, scope, values: _Values,
                    hot_method: bool) -> None:
        in_loop = self.contexts.get(id(call), (False, ()))[0]
        if not (in_loop or hot_method):
            return
        sink = self._sink(call, at, values)
        if sink is None:
            return
        where = ("inside a loop" if in_loop else
                 f"on the step path (via {getattr(scope, 'name', '?')})")
        self._flag(call, "host-sync-in-hot-loop",
                   f"{sink} {where}: the host waits for the card every "
                   "iteration: reduce on the card and pull once a step, or "
                   "sanction it with a justified suppression")

    def _sink(self, call: ast.Call, at: int, values: _Values) -> str | None:
        func = call.func
        name = resolve_call_name(func, self.aliases)
        if name == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if isinstance(func, ast.Attribute):
            if func.attr in _ALWAYS_SYNC and not call.args:
                return f".{func.attr}()"
            if func.attr in _TRACKED_SYNC and not call.args and values.tensor(
                    func.value, at):
                return f".{func.attr}()"
        if name in _VALUE_SINKS and call.args and values.tensor(call.args[0], at):
            return f"{name}()"
        return None


# --------------------------------------------------------------------------
# corpus aggregation and entry points
# --------------------------------------------------------------------------


@dataclass
class _CorpusFacts:
    """Compile sites whose target is defined in another file, routed to
    that file (so its tensor-branch and state-copy passes see them)."""

    foreign_sites: dict[str, list[_CompileSite]] = field(default_factory=dict)


def _module_dotted(rel_path: str) -> str:
    return rel_path[: -len(".py")].replace("/", ".")


def port_files(root: Path | str = PACKAGE_ROOT) -> list[Path]:
    """Every .py file of the package under ``root``: the whole port is in
    scope, so a new module is linted the moment it exists."""
    return sorted(Path(root).rglob("*.py"))


def lint_torch_source(source: str, path: str = "<memory>") -> list[Violation]:
    """Lint one source blob on its own (the unit-test entry point)."""
    tree = ast.parse(textwrap.dedent(source), filename=path)
    if not has_torch_triggers(tree):
        return []
    return _FileLint(tree, path).run()


def lint_torch_paths(
    root: Path | str = PACKAGE_ROOT,
    suppressions: tuple[Suppression, ...] = SUPPRESSIONS,
) -> TorchLintReport:
    """Lint every module under ``root``, apply the suppressions, and report
    what remains (the tier-1 entry point)."""
    root = Path(root)
    report = TorchLintReport()
    trees: list[tuple[ast.Module, str]] = []
    top: dict[str, str] = {}  # dotted function name -> defining file
    for py in port_files(root):
        rel = str(py.relative_to(root.parent))
        tree = ast.parse(py.read_text(), filename=rel)
        report.files_scanned += 1
        if not has_torch_triggers(tree):
            continue
        trees.append((tree, rel))
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                top[f"{_module_dotted(rel)}.{stmt.name}"] = rel
    corpus = _CorpusFacts()
    for tree, rel in trees:
        aliases = collect_aliases(tree)
        for node in ast.walk(tree):
            site = (_decompose_compile(node, aliases)
                    if isinstance(node, ast.Call) else None)
            if site is None or site.target_name is None:
                continue
            dotted = aliases.get(site.target_name)
            target = top.get(dotted or "")
            if target is not None and target != rel:
                # under the defining file's bare name: `from m import f as
                # g; torch.compile(g)` must reach m's `f`
                corpus.foreign_sites.setdefault(target, []).append(
                    dataclasses.replace(site,
                                        target_name=dotted.rsplit(".", 1)[1]))
    found: list[Violation] = []
    for tree, rel in trees:
        found.extend(_FileLint(tree, rel, corpus).run())
    used: set[Suppression] = set()
    for v in found:
        match = next((s for s in suppressions if s.matches(v)), None)
        if match is None:
            report.violations.append(v)
        else:
            used.add(match)
            report.suppressed.append((v, match))
    report.stale_suppressions = [s for s in suppressions if s not in used]
    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return report
