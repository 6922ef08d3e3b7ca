"""Compile a validated ``graph:`` spec into an executable program.

The compiler is deliberately thin: validation (``flow.spec``)
already proved the shape, so compilation is resolution — entrypoint
strings become callables, condition strings become parsed ``ast``
trees, nested graphs become nested ``GraphProgram``s — producing
immutable ``Node`` records the executor schedules.  Scatter widths are
*not* resolved here: ``scatter.over`` may reference an upstream output
that only exists at run time, so fan-out expansion belongs to the
executor."""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Tuple,
                    Union)

from repro_torch.flow.spec import parse_expr, validate_graph


@dataclass(frozen=True)
class RepeatSpec:
    times: Optional[int] = None          # fixed iteration count, or
    until: Optional[ast.Expression] = None   # stop expression ...
    max_iters: Optional[int] = None          # ... with its hard bound

    @property
    def bound(self) -> int:
        return self.times if self.times is not None else self.max_iters


@dataclass(frozen=True)
class Node:
    """One compiled program node (a task, fan-out, loop or subworkflow)."""
    name: str
    deps: Tuple[str, ...] = ()
    fn: Optional[Callable] = None        # task body: fn(ctx, **params)
    params: Mapping[str, Any] = field(default_factory=dict)
    when: Optional[ast.Expression] = None
    scatter_over: Optional[Union[str, List[Any]]] = None
    repeat: Optional[RepeatSpec] = None
    subgraph: Optional["GraphProgram"] = None
    pods: int = 1
    devices_per_pod: int = 0
    inputs: Tuple[str, ...] = ()         # placement keys ({item}/{index}
    outputs: Tuple[str, ...] = ()        # substituted per scatter shard)
    # After subworkflow flattening, dep names are fully qualified
    # ("report.render") but the node's fn / when: / scatter.over were
    # written against LOCAL sibling names ("render"): local_deps holds
    # the local alias for each entry of ``deps`` (empty = identical).
    local_deps: Tuple[str, ...] = ()


@dataclass(frozen=True)
class GraphProgram:
    nodes: Dict[str, Node]               # insertion-ordered

    @property
    def size(self) -> int:
        """Static node count, nested subworkflows included (scatter
        widths are run-time values and count as one here)."""
        return sum(1 + (n.subgraph.size if n.subgraph else 0)
                   for n in self.nodes.values())

    def dependents(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {name: [] for name in self.nodes}
        for n in self.nodes.values():
            for d in n.deps:
                out[d].append(n.name)
        return out


def compile_graph(graph: Mapping[str, Any], *,
                  field_path: str = "spec.graph") -> GraphProgram:
    """Validate + compile one declarative graph spec.  Raises
    ``ManifestError`` (bad shape) or the entrypoint's import error
    surfaced as ``ManifestError`` via ``resolve_entrypoint``."""
    from repro_torch.api.resources import resolve_entrypoint
    validate_graph(graph, field=field_path)
    nodes: Dict[str, Node] = {}
    for i, raw in enumerate(graph["nodes"]):
        name = raw["step"]
        fn = raw.get("fn")
        if fn is None and raw.get("entrypoint") is not None:
            fn = resolve_entrypoint(raw["entrypoint"])
        sub = None
        if raw.get("graph") is not None:
            sub = compile_graph(
                raw["graph"],
                field_path=f"{field_path}.nodes[{i}].graph")
        repeat = None
        if raw.get("repeat") is not None:
            r = raw["repeat"]
            repeat = RepeatSpec(
                times=r.get("times"),
                until=(parse_expr(r["until"],
                                  f"{field_path}.nodes[{i}].repeat.until")
                       if r.get("until") is not None else None),
                max_iters=r.get("max"))
        when = None
        if raw.get("when") is not None:
            when = parse_expr(raw["when"],
                              f"{field_path}.nodes[{i}].when")
        scatter = raw.get("scatter")
        nodes[name] = Node(
            name=name, deps=tuple(raw.get("deps", ())), fn=fn,
            params=dict(raw.get("params") or {}), when=when,
            scatter_over=(list(scatter["over"])
                          if scatter is not None and
                          isinstance(scatter["over"], (list, tuple))
                          else scatter["over"] if scatter is not None
                          else None),
            repeat=repeat, subgraph=sub,
            pods=raw.get("pods", 1),
            devices_per_pod=raw.get("devices_per_pod", 0),
            inputs=tuple(raw.get("inputs", ())),
            outputs=tuple(raw.get("outputs", ())))
    return GraphProgram(nodes=nodes)
