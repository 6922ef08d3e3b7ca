"""Workflow *program* spec — the declarative ``graph:`` language.

The paper's platform is workflow-driven: Kepler programs — not shell
scripts — orchestrate the fabric (§I, §III).  ``repro_torch.core.workflow``
gives us the measured, resumable step list; this module gives those
steps a *program* structure that a manifest can carry:

  graph:
    nodes:
      - step: plan                      # a task node
        entrypoint: pkg.mod:fn          # called fn(ctx, **params)
        params: {...}                   # plain-JSON kwargs
      - step: fetch
        deps: [plan]
        scatter: {over: plan.chunks}    # fan-out: one placed step/item
        entrypoint: pkg.mod:fetch_one
        outputs: ["{item}/raw.npy"]     # {item}/{index} substituted
      - step: tune
        deps: [fetch]
        repeat: {until: "output.loss < 0.1", max: 5}   # bounded loop
        entrypoint: pkg.mod:tune_once
      - step: publish
        deps: [tune]
        when: "tune.loss < 0.2"         # conditional on upstream outputs
        entrypoint: pkg.mod:publish
      - step: report                    # a nested subworkflow
        deps: [publish]
        graph: {nodes: [...]}

Validation here is *eager* and names the offending field as a manifest
path (``spec.graph.nodes[2].scatter.over``) via
``repro_torch.api.resources.ManifestError`` — a bad program fails at
``apply`` time, not three branches into a fan-out.

Conditions (``when:``/``until:``) are a safe expression subset parsed
with ``ast``: comparisons, boolean/arithmetic operators, literals,
dotted/indexed access into upstream step outputs, and the ``len`` /
``min`` / ``max`` / ``abs`` builtins.  Nothing else parses, so a
manifest can never smuggle arbitrary code through a condition string.

A copy of the JAX package's ``flow/spec.py`` with one repair: a dunder
attribute (``x.__class__``) does not parse.  The JAX whitelist admits
every ``ast.Attribute``, and ``eval_expr`` reads one of a non-mapping
with ``getattr``, which reaches an object's internals.
"""
from __future__ import annotations

import ast
import re
from typing import Any, List, Mapping, Sequence, Set

# name charset: "#" is reserved for branch shards (``seg#3``), "." for
# nested subworkflow steps (``report.render``) and output references
_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]*$")

NODE_KEYS = frozenset({
    "step", "deps", "entrypoint", "fn", "params", "when", "scatter",
    "repeat", "graph", "pods", "devices_per_pod", "inputs", "outputs"})
SCATTER_KEYS = frozenset({"over"})
REPEAT_KEYS = frozenset({"times", "until", "max"})

# the ``ast`` node types a condition expression may contain
_ALLOWED_EXPR_NODES = (
    ast.Expression, ast.BoolOp, ast.And, ast.Or, ast.UnaryOp, ast.Not,
    ast.USub, ast.UAdd, ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE,
    ast.Gt, ast.GtE, ast.In, ast.NotIn, ast.Is, ast.IsNot, ast.BinOp,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
    ast.Constant, ast.Name, ast.Load, ast.Attribute, ast.Subscript,
    ast.Index, ast.List, ast.Tuple, ast.Call)

_ALLOWED_CALLS = {"len": len, "min": min, "max": max, "abs": abs,
                  "sum": sum, "round": round}


def _err(message: str, field: str):
    from repro_torch.api.resources import ManifestError
    return ManifestError(message, field=field)


# ------------------------------------------------------------- expressions
def parse_expr(text: str, field: str) -> ast.Expression:
    """Parse a condition string, rejecting anything outside the safe
    subset.  Raises ``ManifestError`` naming ``field``."""
    if not isinstance(text, str) or not text.strip():
        raise _err("must be a non-empty expression string", field)
    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError as e:
        raise _err(f"invalid expression: {e.msg}", field) from e
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_EXPR_NODES):
            raise _err(
                f"expression may not contain {type(node).__name__}; "
                f"allowed: comparisons, and/or/not, arithmetic, "
                f"literals, name.attr / name[i] access, and "
                f"{sorted(_ALLOWED_CALLS)} calls", field)
        if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
            raise _err(f"expression may not read the dunder attribute "
                       f"{node.attr!r}", field)
        if isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name) and
                    node.func.id in _ALLOWED_CALLS) or node.keywords:
                raise _err(
                    f"only {sorted(_ALLOWED_CALLS)} may be called",
                    field)
    return tree


def expr_roots(tree: ast.Expression) -> Set[str]:
    """The root names an expression reads (``train.loss < x`` ->
    ``{"train", "x"}``), excluding the whitelisted builtins."""
    return {n.id for n in ast.walk(tree)
            if isinstance(n, ast.Name) and n.id not in _ALLOWED_CALLS}


def eval_expr(tree: ast.Expression, names: Mapping[str, Any]):
    """Evaluate a parsed condition against a namespace of step outputs.
    Attribute access works on mappings (``train.loss`` reads
    ``names["train"]["loss"]``)."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in names:
                raise KeyError(
                    f"condition references {node.id!r}; available: "
                    f"{sorted(names)}")
            return names[node.id]
        if isinstance(node, ast.Attribute):
            base = ev(node.value)
            if isinstance(base, Mapping):
                if node.attr not in base:
                    raise KeyError(
                        f"output has no key {node.attr!r}; available: "
                        f"{sorted(base)}")
                return base[node.attr]
            return getattr(base, node.attr)
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Index):        # py<3.9 compat shape
                sl = sl.value
            return ev(node.value)[ev(sl)]
        if isinstance(node, (ast.List, ast.Tuple)):
            return [ev(e) for e in node.elts]
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            if isinstance(node.op, ast.Not):
                return not v
            return -v if isinstance(node.op, ast.USub) else +v
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                out = True
                for v in node.values:
                    out = ev(v)
                    if not out:
                        return out
                return out
            for v in node.values:
                out = ev(v)
                if out:
                    return out
            return out
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            op = type(node.op)
            return {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                    ast.Mult: lambda: a * b, ast.Div: lambda: a / b,
                    ast.FloorDiv: lambda: a // b,
                    ast.Mod: lambda: a % b}[op]()
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            for op, cmp in zip(node.ops, node.comparators):
                right = ev(cmp)
                ok = {ast.Eq: lambda: left == right,
                      ast.NotEq: lambda: left != right,
                      ast.Lt: lambda: left < right,
                      ast.LtE: lambda: left <= right,
                      ast.Gt: lambda: left > right,
                      ast.GtE: lambda: left >= right,
                      ast.In: lambda: left in right,
                      ast.NotIn: lambda: left not in right,
                      ast.Is: lambda: left is right,
                      ast.IsNot: lambda: left is not right}[type(op)]()
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.Call):
            return _ALLOWED_CALLS[node.func.id](*[ev(a) for a in node.args])
        raise TypeError(f"unsupported expression node {type(node).__name__}")

    return ev(tree)


# --------------------------------------------------------------- validation
def _check_ref(ref: str, deps: Sequence[str], field: str) -> None:
    """A ``scatter.over`` output reference: ``dep`` or ``dep.path.to.list``
    whose root must be a declared dependency."""
    if not isinstance(ref, str) or not ref:
        raise _err("must be a non-empty output reference "
                   "('dep' or 'dep.key')", field)
    root = ref.split(".", 1)[0].split("[", 1)[0]
    if root not in deps:
        raise _err(
            f"references {root!r}, which is not in this node's deps "
            f"{sorted(deps)}", field)


def _validate_node(node, idx: int, names: Set[str], field: str) -> None:
    f = f"{field}.nodes[{idx}]"
    if not isinstance(node, Mapping):
        raise _err(f"each node must be an object, got "
                   f"{type(node).__name__}", f)
    unknown = set(node) - NODE_KEYS
    if unknown:
        raise _err(f"unknown node keys {sorted(unknown)}; known: "
                   f"{sorted(NODE_KEYS)}", f"{f}.{sorted(unknown)[0]}")
    name = node.get("step")
    if not isinstance(name, str) or not _NAME_RE.match(name or ""):
        raise _err("step name must match [A-Za-z][A-Za-z0-9_-]* "
                   "('#' and '.' are reserved for branches/subworkflows)",
                   f"{f}.step")
    deps = node.get("deps", [])
    if not isinstance(deps, (list, tuple)):
        raise _err(f"must be a list of step names, got "
                   f"{type(deps).__name__}", f"{f}.deps")
    for j, d in enumerate(deps):
        if not isinstance(d, str) or d not in names:
            raise _err(f"unknown dependency {d!r}; known steps: "
                       f"{sorted(names)}", f"{f}.deps[{j}]")
        if d == name:
            raise _err("a step cannot depend on itself", f"{f}.deps[{j}]")

    # exactly one body: entrypoint | fn | graph
    bodies = [k for k in ("entrypoint", "fn", "graph") if node.get(k)
              is not None]
    if len(bodies) != 1:
        raise _err("each node needs exactly one of entrypoint (manifest), "
                   f"fn (runtime callable) or graph (nested subworkflow); "
                   f"got {bodies or 'none'}", f"{f}.entrypoint")
    if node.get("entrypoint") is not None:
        ep = node["entrypoint"]
        if not isinstance(ep, str) or ":" not in ep:
            raise _err("must look like 'pkg.module:attr'",
                       f"{f}.entrypoint")
    if node.get("fn") is not None and not callable(node["fn"]):
        raise _err("must be a callable (runtime-only; use entrypoint in "
                   "manifests)", f"{f}.fn")
    if node.get("graph") is not None:
        if node.get("scatter") is not None or node.get("repeat") is not None:
            raise _err("scatter/repeat cannot wrap a nested subworkflow",
                       f"{f}.graph")
        validate_graph(node["graph"], field=f"{f}.graph")

    params = node.get("params")
    if params is not None and not isinstance(params, Mapping):
        raise _err(f"must be an object of kwargs, got "
                   f"{type(params).__name__}", f"{f}.params")
    for k, typ, lo in (("pods", int, 1), ("devices_per_pod", int, 0)):
        v = node.get(k)
        if v is not None and (not isinstance(v, int)
                              or isinstance(v, bool) or v < lo):
            raise _err(f"must be an int >= {lo}", f"{f}.{k}")
    for k in ("inputs", "outputs"):
        v = node.get(k, [])
        if not isinstance(v, (list, tuple)) or \
                not all(isinstance(s, str) for s in v):
            raise _err("must be a list of dataset key strings", f"{f}.{k}")

    if node.get("when") is not None:
        tree = parse_expr(node["when"], f"{f}.when")
        for root in expr_roots(tree):
            if root not in deps:
                raise _err(
                    f"reads {root!r}, which is not in this node's deps "
                    f"{sorted(deps)} — conditions see dependency outputs "
                    f"only", f"{f}.when")

    scatter = node.get("scatter")
    if scatter is not None:
        if not isinstance(scatter, Mapping):
            raise _err(f"must be an object {{over: ...}}, got "
                       f"{type(scatter).__name__}", f"{f}.scatter")
        unknown = set(scatter) - SCATTER_KEYS
        if unknown:
            raise _err(f"unknown scatter keys {sorted(unknown)}; known: "
                       f"{sorted(SCATTER_KEYS)}",
                       f"{f}.scatter.{sorted(unknown)[0]}")
        if "over" not in scatter:
            raise _err("required field missing", f"{f}.scatter.over")
        over = scatter["over"]
        if isinstance(over, (list, tuple)):
            if not over:
                raise _err("a literal scatter list may not be empty",
                           f"{f}.scatter.over")
        else:
            _check_ref(over, deps, f"{f}.scatter.over")
        if node.get("repeat") is not None:
            raise _err("scatter and repeat cannot combine on one node; "
                       "nest a subworkflow instead", f"{f}.scatter")

    repeat = node.get("repeat")
    if repeat is not None:
        if not isinstance(repeat, Mapping):
            raise _err(f"must be an object {{times: N}} or "
                       f"{{until: expr, max: N}}, got "
                       f"{type(repeat).__name__}", f"{f}.repeat")
        unknown = set(repeat) - REPEAT_KEYS
        if unknown:
            raise _err(f"unknown repeat keys {sorted(unknown)}; known: "
                       f"{sorted(REPEAT_KEYS)}",
                       f"{f}.repeat.{sorted(unknown)[0]}")
        times, until = repeat.get("times"), repeat.get("until")
        if (times is None) == (until is None):
            raise _err("needs exactly one of times (fixed count) or "
                       "until (stop expression, with max)",
                       f"{f}.repeat")
        if times is not None and (not isinstance(times, int)
                                  or isinstance(times, bool) or times < 1):
            raise _err("must be an int >= 1", f"{f}.repeat.times")
        if until is not None:
            bound = repeat.get("max")
            if not isinstance(bound, int) or isinstance(bound, bool) \
                    or bound < 1:
                raise _err("an until-loop must declare max (an int >= 1): "
                           "every loop in a workflow program is bounded",
                           f"{f}.repeat.max")
            tree = parse_expr(until, f"{f}.repeat.until")
            for root in expr_roots(tree):
                if root not in deps and root not in ("output", "i"):
                    raise _err(
                        f"reads {root!r}; until-conditions see dependency "
                        f"outputs, 'output' (the iteration's result) and "
                        f"'i' (the iteration index)", f"{f}.repeat.until")


def validate_graph(graph, *, field: str = "spec.graph") -> None:
    """Validate a declarative graph spec (see module docstring), raising
    ``ManifestError`` with the offending manifest path.  Checks node
    shapes, name uniqueness, dependency existence, condition/loop/scatter
    well-formedness, and acyclicity."""
    if not isinstance(graph, Mapping):
        raise _err(f"must be an object with a 'nodes' list, got "
                   f"{type(graph).__name__}", field)
    unknown = set(graph) - {"nodes"}
    if unknown:
        raise _err(f"unknown graph keys {sorted(unknown)}; known: "
                   f"['nodes']", f"{field}.{sorted(unknown)[0]}")
    nodes = graph.get("nodes")
    if not isinstance(nodes, (list, tuple)) or not nodes:
        raise _err("must be a non-empty list of nodes", f"{field}.nodes")

    names: Set[str] = set()
    for i, node in enumerate(nodes):
        if isinstance(node, Mapping):
            name = node.get("step")
            if isinstance(name, str):
                if name in names:
                    raise _err(f"duplicate step name {name!r}",
                               f"{field}.nodes[{i}].step")
                names.add(name)
    for i, node in enumerate(nodes):
        _validate_node(node, i, names, field)

    # acyclicity over the declared edges
    deps = {n["step"]: list(n.get("deps", [])) for n in nodes}
    seen: Set[str] = set()
    visiting: List[str] = []

    def visit(name: str) -> None:
        if name in seen:
            return
        if name in visiting:
            cyc = visiting[visiting.index(name):] + [name]
            raise _err(f"dependency cycle: {' -> '.join(cyc)}",
                       f"{field}.nodes")
        visiting.append(name)
        for d in deps[name]:
            visit(d)
        visiting.pop()
        seen.add(name)

    for name in deps:
        visit(name)
