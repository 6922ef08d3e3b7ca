"""Workflow programs: declarative graph specs compiled to concurrent,
branch-resumable execution plans over the federated fabric.

Layers: ``spec`` validates the ``graph:`` manifest shape (field-naming
``ManifestError``s) and hosts the safe expression language used by
``when:`` / ``repeat.until:``; ``compiler`` resolves the validated spec
into an immutable ``GraphProgram``; ``executor`` schedules ready nodes
concurrently over a bounded pool on top of a ``Workflow`` substrate,
keeping per-step marker semantics so fan-out branches resume
individually.  A copy of the JAX package's ``flow``; its store layout
(markers, output manifests) is the JAX one, so a run started by either
stack resumes under the other."""
from repro_torch.flow.compiler import (GraphProgram, Node, RepeatSpec,
                                      compile_graph)
from repro_torch.flow.executor import GraphRunner, flatten, run_graph
from repro_torch.flow.spec import (eval_expr, expr_roots, parse_expr,
                                  validate_graph)

__all__ = [
    "GraphProgram", "GraphRunner", "Node", "RepeatSpec", "compile_graph",
    "eval_expr", "expr_roots", "flatten", "parse_expr", "run_graph",
    "validate_graph",
]
