"""Concurrent graph executor — ready-set scheduling over a bounded pool.

``GraphRunner`` executes a compiled :class:`~repro_torch.flow.compiler.GraphProgram`
on top of an existing :class:`repro_torch.core.workflow.Workflow` — the
Workflow contributes the placed-step machinery (planner scoring,
pre-staging, marker/output store semantics, Table-I reports, EventBus
emission); the runner contributes the *program* semantics:

  * independent branches run **concurrently** (a bounded worker pool;
    each ready step is submitted the moment its dependencies resolve);
  * ``when:`` conditionals are evaluated against upstream outputs; a
    false condition skips the node and cascades to its dependents;
  * ``scatter:`` fan-out expands at run time into one placed step per
    item (``seg#0`` … ``seg#N-1``), each individually marked — a
    crashed 50-branch fan-out resumes ONLY its missing branches — and a
    gather step collects shard outputs in index order;
  * ``repeat:`` loops run iterations ``tune#0`` … sequentially (the
    carry is loop-ordered), each iteration marked, ``until:`` stop
    expressions re-evaluated deterministically on resume;
  * nested subworkflows arrive pre-flattened (``report.render``) from
    the compiler's inliner, so they schedule like any other branch;
  * cancellation (``should_stop``) is polled per branch: no new branch
    launches after the signal, queued pool work is revoked, running
    steps finish their unit and keep their markers, and the monitor
    sees one workflow-level ``cancelled`` event plus a ``skipped``
    event for every step that will not run.

Events: logical nodes publish on kind ``step`` (placed / done /
skipped / scatter), scatter shards and loop iterations on kind
``branch`` with ``of=<node>`` and ``branch=<index>``.
"""
from __future__ import annotations

import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

from repro_torch.core.workflow import Step, Workflow
from repro_torch.flow.compiler import GraphProgram, Node, compile_graph
from repro_torch.flow.spec import eval_expr, parse_expr


def _substitute(keys, item, index) -> List[str]:
    """Placement dataset keys for one scatter shard: ``{item}`` /
    ``{index}`` placeholders become the shard's values."""
    out = []
    for k in keys:
        out.append(k.replace("{item}", str(item))
                    .replace("{index}", str(index)))
    return out


def _deps_namespace(node: Node, outputs: Mapping[str, Any]) -> Dict[str, Any]:
    """Upstream outputs keyed by the node's LOCAL dep names — what its
    fn inputs, ``when:`` and ``scatter.over`` were written against."""
    local = node.local_deps or node.deps
    return {loc: outputs.get(full) for full, loc in zip(node.deps, local)}


def _resolve_ref(ref: str, outputs: Mapping[str, Any], node: str):
    """``scatter.over`` reference -> the runtime list it names."""
    tree = parse_expr(ref, f"graph.nodes[{node}].scatter.over")
    try:
        items = eval_expr(tree, outputs)
    except (KeyError, TypeError) as e:
        raise RuntimeError(
            f"graph node {node!r}: scatter.over {ref!r} did not resolve "
            f"against upstream outputs: {e}") from e
    if not isinstance(items, (list, tuple)):
        raise RuntimeError(
            f"graph node {node!r}: scatter.over {ref!r} must name a "
            f"list, got {type(items).__name__}")
    return list(items)


def _flatten_into(node: Node, prefix: str, extra_deps, inherited_when,
                  flat: Dict[str, Node]) -> None:
    """Inline one (possibly nested-subworkflow) node.  ``extra_deps`` is
    a list of ``(full, local)`` dep pairs the enclosing subworkflow node
    carried — subgraph roots inherit them (and the sub node's ``when:``)
    so the whole subgraph waits on, and can reference, what the sub node
    declared."""
    name = prefix + node.name
    if node.deps:
        pairs = [(prefix + d, d) for d in node.deps]
        when = node.when
    else:
        pairs = list(extra_deps)
        when = node.when if node.when is not None else inherited_when
    deps = tuple(full for full, _ in pairs)
    local = tuple(loc for _, loc in pairs)
    if node.subgraph is None:
        flat[name] = Node(
            name=name, deps=deps, fn=node.fn, params=node.params,
            when=when, scatter_over=node.scatter_over,
            repeat=node.repeat, pods=node.pods,
            devices_per_pod=node.devices_per_pod,
            inputs=node.inputs, outputs=node.outputs, local_deps=local)
        return
    sub_prefix = name + "."
    for child in node.subgraph.nodes.values():
        _flatten_into(child, sub_prefix, pairs, when, flat)
    # synthetic collect node: dependents of the sub node see one dict
    # {child: output}; its deps are fully-qualified on BOTH sides
    children = [sub_prefix + c for c in node.subgraph.nodes]
    flat[name] = Node(name=name, deps=tuple(children),
                      local_deps=tuple(children),
                      params={"_collect": children})


def flatten(prog: GraphProgram) -> GraphProgram:
    """Inline nested subworkflows: child ``c`` of sub node ``s`` becomes
    ``s.c``, scheduling — and resuming — exactly like a top-level node."""
    flat: Dict[str, Node] = {}
    for node in prog.nodes.values():
        _flatten_into(node, "", [], None, flat)
    return GraphProgram(nodes=flat)


class GraphRunner:
    """Execute one compiled graph program on a Workflow substrate."""

    def __init__(self, wf: Workflow, program, *, max_workers: int = 8):
        if isinstance(program, Mapping):
            program = compile_graph(program)
        self.wf = wf
        self.program = flatten(program)
        self.max_workers = max(1, int(max_workers))
        self._lock = threading.Lock()
        self._outputs: Dict[str, Any] = {}

    # ----------------------------------------------------------- plumbing
    def _step_for(self, node: Node, *, name: Optional[str] = None,
                  fn=None, inputs=(), outputs=()) -> Step:
        step = Step(name or node.name, fn, deps=node.deps,
                    pods=node.pods,
                    devices_per_pod=node.devices_per_pod,
                    inputs=tuple(inputs), outputs=tuple(outputs))
        with self.wf._lock:
            self.wf.steps.setdefault(step.name, step)
        return step

    def _marker_done(self, name: str) -> bool:
        return self.wf._ctrl().exists(Step(name, None).marker_key(
            self.wf.name))

    # --------------------------------------------------------- node bodies
    def _task_fn(self, node: Node):
        if node.params.get("_collect") is not None:
            children = node.params["_collect"]
            return lambda ctx: {c[len(node.name) + 1:]: ctx.inputs[c]
                                for c in children}
        fn, params = node.fn, dict(node.params)
        return lambda ctx: fn(ctx, **params)

    def _run_task(self, node: Node, inputs: Dict[str, Any], resume: bool):
        step = self._step_for(node, fn=self._task_fn(node),
                              inputs=node.inputs, outputs=node.outputs)
        out, _ = self.wf._exec_step(step, inputs, resume, concurrent=True)
        return out

    def _run_shard(self, node: Node, index: int, item, deps_out,
                   resume: bool, stop) -> Any:
        if stop():            # revoked-after-start race: skip, no marker
            return _CANCELLED
        fn, params = node.fn, dict(node.params)
        step = self._step_for(
            node, name=f"{node.name}#{index}",
            fn=lambda ctx: fn(ctx, **params),
            inputs=_substitute(node.inputs, item, index),
            outputs=_substitute(node.outputs, item, index))
        inputs = {**deps_out, "item": item, "index": index}
        out, _ = self.wf._exec_step(step, inputs, resume,
                                    emit_kind="branch", concurrent=True,
                                    of=node.name, branch=index)
        return out

    def _run_repeat(self, node: Node, inputs: Dict[str, Any],
                    resume: bool, stop):
        """Bounded loop: iterations are sequential (the carry is
        loop-ordered) but each is its own marked, resumable step; the
        stop signal is honored at every iteration boundary."""
        prev = None
        for i in range(node.repeat.bound):
            if stop():
                return _CANCELLED
            fn, params = node.fn, dict(node.params)
            step = self._step_for(node, name=f"{node.name}#{i}",
                                  fn=lambda ctx: fn(ctx, **params),
                                  inputs=node.inputs,
                                  outputs=node.outputs)
            it_inputs = {**inputs, "i": i, "prev": prev}
            prev, _ = self.wf._exec_step(step, it_inputs, resume,
                                         emit_kind="branch",
                                         concurrent=True, of=node.name,
                                         branch=i)
            if node.repeat.until is not None and eval_expr(
                    node.repeat.until, {**inputs, "output": prev, "i": i}):
                break
        # the logical node's own marked step: its output is the final
        # iteration's, so downstream deps (and when:-conditions) read it
        # like any task output; the marker makes resume skip the loop
        # wholesale once it has converged
        step = self._step_for(node, fn=lambda ctx, out=prev: out)
        out, _ = self.wf._exec_step(step, {}, resume, concurrent=True)
        return out

    # ---------------------------------------------------------------- run
    def run(self, *, resume: bool = True, only: Optional[str] = None,
            should_stop=None) -> Dict[str, Any]:
        stop = should_stop or (lambda: False)
        nodes = self.program.nodes
        if only is not None:
            if only not in nodes:
                raise RuntimeError(
                    f"graph has no step {only!r}; steps: {sorted(nodes)}")
            return self._run_only(nodes[only], resume, stop)

        state: Dict[str, str] = {n: "pending" for n in nodes}
        cond_skipped: Set[str] = set()
        futures: Dict[Any, Tuple[str, Optional[int]]] = {}
        shards: Dict[str, Dict[str, Any]] = {}
        failure: Optional[BaseException] = None
        cancelled = False

        def deps_ready(node: Node) -> bool:
            return all(state[d] in ("done", "skipped") for d in node.deps)

        def deps_out(node: Node) -> Dict[str, Any]:
            return _deps_namespace(node, self._outputs)

        pool = ThreadPoolExecutor(max_workers=self.max_workers,
                                  thread_name_prefix=f"flow-{self.wf.name}")
        try:
            while True:
                if not cancelled and failure is None and stop():
                    cancelled = True
                    self._revoke(futures, nodes, state)
                    remaining = [n for n, s in state.items()
                                 if s in ("pending", "ready")]
                    self.wf._emit_workflow("cancelled",
                                           remaining=len(remaining))
                    for n in remaining:
                        state[n] = "skipped"
                        cond_skipped.add(n)   # do not run dependents
                        self.wf._emit(n, "skipped", reason="cancelled")

                if failure is None and not cancelled:
                    for name, node in nodes.items():
                        if state[name] != "pending" or not deps_ready(node):
                            continue
                        if any(d in cond_skipped for d in node.deps):
                            state[name] = "skipped"
                            cond_skipped.add(name)
                            self.wf._emit(name, "skipped",
                                          reason="when-upstream")
                            continue
                        if node.when is not None and not self._when(
                                node, deps_out(node)):
                            state[name] = "skipped"
                            cond_skipped.add(name)
                            self.wf._emit(name, "skipped", reason="when")
                            continue
                        state[name] = "running"
                        self._launch(pool, futures, shards, node,
                                     deps_out(node), resume, stop)

                if not futures:
                    if cancelled or failure is not None or all(
                            s in ("done", "skipped")
                            for s in state.values()):
                        break
                    # nothing running and nothing launchable: a bug
                    stuck = [n for n, s in state.items() if s == "pending"]
                    raise RuntimeError(
                        f"graph stalled with pending steps {stuck}")

                done_futs, _ = wait(list(futures), timeout=0.05,
                                    return_when=FIRST_COMPLETED)
                for fut in done_futs:
                    name, shard = futures.pop(fut)
                    try:
                        result = fut.result()
                    except BaseException as e:   # first failure wins
                        if failure is None:
                            failure = e
                            self._revoke(futures, nodes, state)
                        continue
                    if shard is None:
                        if result is _CANCELLED:
                            state[name] = "skipped"
                            continue
                        self._finish(name, result, state)
                    else:
                        self._shard_done(
                            pool, futures, shards, nodes[name], shard,
                            result, resume, state,
                            launch_ok=(failure is None and not cancelled))
        finally:
            pool.shutdown(wait=True)
        if failure is not None:
            raise failure
        with self.wf._lock:
            self.wf.results.update(self._outputs)
        return dict(self._outputs)

    # ------------------------------------------------------------ helpers
    def _when(self, node: Node, deps_out: Dict[str, Any]) -> bool:
        try:
            return bool(eval_expr(node.when, deps_out))
        except (KeyError, TypeError) as e:
            raise RuntimeError(
                f"graph node {node.name!r}: when-condition failed to "
                f"evaluate: {e}") from e

    def _finish(self, name: str, output, state) -> None:
        state[name] = "done"
        with self._lock:
            self._outputs[name] = output

    def _launch(self, pool, futures, shards, node: Node,
                deps_out: Dict[str, Any], resume: bool, stop) -> None:
        if node.scatter_over is not None and not (
                resume and self._marker_done(node.name)):
            items = node.scatter_over if isinstance(node.scatter_over, list) \
                else _resolve_ref(node.scatter_over, deps_out, node.name)
            self.wf._emit(node.name, "scatter", width=len(items))
            shards[node.name] = {"items": items, "deps_out": deps_out,
                                 "outs": {}, "left": len(items)}
            for i, item in enumerate(items):
                fut = pool.submit(self._run_shard, node, i, item,
                                  deps_out, resume, stop)
                futures[fut] = (node.name, i)
            return
        if node.scatter_over is not None:
            # whole fan-out already gathered: the logical marker resolves
            # it without expanding a single shard
            fut = pool.submit(self._load_gathered, node)
        elif node.repeat is not None:
            fut = pool.submit(self._run_repeat, node, deps_out, resume,
                              stop)
        else:
            fut = pool.submit(self._run_task, node, deps_out, resume)
        futures[fut] = (node.name, None)

    def _load_gathered(self, node: Node):
        step = self._step_for(node, fn=lambda ctx: None)
        out, _ = self.wf._exec_step(step, {}, True, concurrent=True)
        return out

    def _shard_done(self, pool, futures, shards, node: Node, index: int,
                    result, resume: bool, state, *,
                    launch_ok: bool = True) -> None:
        rec = shards[node.name]
        rec["left"] -= 1
        if result is _CANCELLED:
            rec["cancelled"] = True
        else:
            rec["outs"][index] = result
        if rec["left"] > 0:
            return
        if (not launch_ok or rec.get("cancelled")
                or len(rec["outs"]) != len(rec["items"])):
            state[node.name] = "skipped"   # incomplete fan-out: no gather
            return
        gathered = [rec["outs"][i] for i in range(len(rec["items"]))]
        step = self._step_for(node, fn=lambda ctx: gathered)
        fut = pool.submit(
            lambda: self.wf._exec_step(step, {}, resume,
                                       concurrent=True)[0])
        futures[fut] = (node.name, None)

    def _revoke(self, futures, nodes, state) -> None:
        """Cancel queued-but-unstarted pool work (running steps finish
        their unit and keep their markers)."""
        for fut, (name, shard) in list(futures.items()):
            if fut.cancel():
                del futures[fut]
                if shard is None:
                    state[name] = "skipped"
                else:
                    self.wf._emit(f"{name}#{shard}", "skipped",
                                  kind="branch", of=name, branch=shard,
                                  reason="cancelled")

    def _run_only(self, node: Node, resume: bool, stop) -> Dict[str, Any]:
        """PPoDS isolation: run ONE node, its dependencies resolved from
        their stored outputs (clear error when a dep never completed)."""
        for d in node.deps:
            if not self._marker_done(d):
                raise RuntimeError(
                    f"workflow {self.wf.name!r}: step {node.name!r} "
                    f"depends on {d!r}, which has not completed — run it "
                    f"first or drop only=")
            self._outputs[d] = self.wf._load_output(Step(d, None))
        deps_out = _deps_namespace(node, self._outputs)
        if node.when is not None and not self._when(node, deps_out):
            self.wf._emit(node.name, "skipped", reason="when")
            return dict(self._outputs)
        if node.repeat is not None:
            out = self._run_repeat(node, deps_out, resume, stop)
        elif node.scatter_over is not None:
            out = self._only_scatter(node, deps_out, resume, stop)
        else:
            out = self._run_task(node, deps_out, resume)
        if out is not _CANCELLED:
            self._outputs[node.name] = out
            with self.wf._lock:
                self.wf.results.update(self._outputs)
        return dict(self._outputs)

    def _only_scatter(self, node: Node, deps_out, resume: bool, stop):
        if resume and self._marker_done(node.name):
            return self._load_gathered(node)
        items = node.scatter_over if isinstance(node.scatter_over, list) \
            else _resolve_ref(node.scatter_over, deps_out, node.name)
        self.wf._emit(node.name, "scatter", width=len(items))
        outs = []
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            futs = [pool.submit(self._run_shard, node, i, item, deps_out,
                                resume, stop)
                    for i, item in enumerate(items)]
            for fut in futs:
                outs.append(fut.result())   # submission order == index
        if any(o is _CANCELLED for o in outs):
            return _CANCELLED
        gathered = outs
        step = self._step_for(node, fn=lambda ctx: gathered)
        return self.wf._exec_step(step, {}, resume, concurrent=True)[0]


class _Cancelled:
    __slots__ = ()

    def __repr__(self):
        return "<cancelled>"


_CANCELLED = _Cancelled()


def run_graph(wf: Workflow, graph, *, resume: bool = True,
              only: Optional[str] = None, should_stop=None,
              max_workers: int = 8) -> Dict[str, Any]:
    """One-call form: compile ``graph`` (a declarative spec dict or a
    pre-compiled ``GraphProgram``) and execute it on ``wf``."""
    runner = GraphRunner(wf, graph, max_workers=max_workers)
    return runner.run(resume=resume, only=only, should_stop=should_stop)
