"""Typed, versioned workload resources — the kubectl-manifest analogue.

The paper's platform is *declarative*: users hand Kubernetes a manifest
describing what should run, and the controllers make it so (§II, §VI).
This module is that surface for the repro: five workload kinds —

  * ``TrainJob``     — self-healing elastic training (``elastic``);
  * ``ServeJob``     — continuous-batching inference (``serving``);
  * ``BatchJob``     — a plain orchestrator Job (``core.orchestrator``);
  * ``WorkflowRun``  — a measured, resumable step DAG (``core.workflow``);
  * ``RLJob``        — actor fleet + elastic RL learner (``rl``);

each a frozen dataclass with a lossless ``to_manifest()`` /
``from_manifest()`` pair (plain dict/JSON — the YAML analogue), defaults
for everything a smoke run doesn't care about, and validation that names
the offending field instead of exploding somewhere downstream.

Two fields are *runtime-only* (callables cannot ride in a manifest):
``BatchJob.fn`` and ``WorkflowRun.define``.  Their declarative twins are
``entrypoint`` strings (``"pkg.module:attr"``) resolved at apply time, so
a manifest on disk can still describe every kind end to end.  Runtime
fields are excluded from manifests AND from equality, so the round-trip
law ``from_manifest(to_manifest(spec)) == spec`` holds for every spec.

``repro_torch.api.Session.apply`` accepts any of these and routes it to
the matching subsystem on whichever backend the session wraps.

A copy of the JAX package's ``api/resources.py``: the same kinds, fields,
defaults and validation, so a manifest means the same workload in both
stacks and round-trips between them unchanged.  No field names a device:
the session's ``Cluster`` owns it.  An entrypoint is imported as named:
one under ``repro.`` would pull the JAX package into the process, so the
port's manifests name functions of ``repro_torch`` or of their caller.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import typing
from dataclasses import dataclass, field
from typing import (Any, Callable, ClassVar, Dict, List, Mapping, Optional,
                    Tuple, Type, Union)

API_VERSION = "repro/v1"


class ManifestError(ValueError):
    """A manifest (or a directly constructed spec) failed validation.

    ``field`` names the offending field as a manifest path
    (``"spec.steps"``, ``"metadata.name"``, ``"kind"``) so callers — and
    error messages — can point at exactly what to fix."""

    def __init__(self, message: str, *, field: Optional[str] = None):
        self.field = field
        super().__init__(message if field is None
                         else f"{field}: {message}")


def _require(cond: bool, message: str, field: str) -> None:
    if not cond:
        raise ManifestError(message, field=field)


# --------------------------------------------------------------- coercion
def _type_name(hint) -> str:
    return getattr(hint, "__name__", str(hint).replace("typing.", ""))


def _coerce(path: str, value, hint):
    """Check ``value`` against the dataclass type ``hint`` (converting
    JSON lists back to tuples where the field wants tuples) or raise a
    ManifestError naming ``path``."""
    if hint is Any:
        return value
    origin = typing.get_origin(hint)
    if origin is Union:
        args = typing.get_args(hint)
        if value is None:
            _require(type(None) in args, "may not be null", path)
            return None
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1:
            # Optional[X]: X's own (element-precise) error is the message
            return _coerce(path, value, non_none[0])
        for a in non_none:
            try:
                return _coerce(path, value, a)
            except ManifestError:
                continue
        raise ManifestError(
            f"expected {_type_name(hint)}, got {type(value).__name__}",
            field=path)
    if origin is tuple:
        _require(isinstance(value, (list, tuple)),
                 f"expected a list, got {type(value).__name__}", path)
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(f"{path}[{i}]", v, args[0])
                         for i, v in enumerate(value))
        _require(len(value) == len(args),
                 f"expected {len(args)} items, got {len(value)}", path)
        return tuple(_coerce(f"{path}[{i}]", v, a)
                     for i, (v, a) in enumerate(zip(value, args)))
    if origin is list:
        _require(isinstance(value, (list, tuple)),
                 f"expected a list, got {type(value).__name__}", path)
        (item_t,) = typing.get_args(hint) or (Any,)
        return [_coerce(f"{path}[{i}]", v, item_t)
                for i, v in enumerate(value)]
    if origin is dict or hint is dict:
        _require(isinstance(value, Mapping),
                 f"expected an object, got {type(value).__name__}", path)
        args = typing.get_args(hint)
        val_t = args[1] if args else Any
        out = {}
        for k, v in value.items():
            _require(isinstance(k, str), "object keys must be strings",
                     path)
            out[k] = _coerce(f"{path}.{k}", v, val_t)
        return out
    if hint is int:
        _require(isinstance(value, int) and not isinstance(value, bool),
                 f"expected an int, got {type(value).__name__}", path)
        return value
    if hint is float:
        _require(isinstance(value, (int, float)) and
                 not isinstance(value, bool),
                 f"expected a number, got {type(value).__name__}", path)
        return float(value)
    if hint is bool:
        _require(isinstance(value, bool),
                 f"expected a bool, got {type(value).__name__}", path)
        return value
    if hint is str:
        _require(isinstance(value, str),
                 f"expected a string, got {type(value).__name__}", path)
        return value
    return value


def _jsonable(value):
    """Dataclass field value -> plain JSON value (tuples become lists)."""
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, Mapping):
        return {k: _jsonable(v) for k, v in value.items()}
    return value


def resolve_entrypoint(path: str) -> Callable:
    """``"pkg.module:attr"`` -> the attr, imported.  The declarative twin
    of a runtime callable field."""
    mod, sep, attr = path.partition(":")
    if not sep or not mod or not attr:
        raise ManifestError(
            f"entrypoint {path!r} must look like 'pkg.module:attr'",
            field="spec.entrypoint")
    try:
        target = importlib.import_module(mod)
    except ImportError as e:
        raise ManifestError(f"cannot import {mod!r}: {e}",
                            field="spec.entrypoint") from e
    try:
        for part in attr.split("."):
            target = getattr(target, part)
    except AttributeError as e:
        raise ManifestError(f"{mod!r} has no attribute {attr!r}",
                            field="spec.entrypoint") from e
    return target


# -------------------------------------------------------------- resources
def _runtime_field(**kw):
    """A callable slot excluded from manifests and equality."""
    return field(default=None, compare=False, repr=False,
                 metadata={"manifest": False}, **kw)


class WorkloadResource:
    """Shared manifest plumbing for the workload kinds."""

    KIND: ClassVar[str] = ""

    def _canonicalize(self, *names: str) -> None:
        """Normalize free-form (Any-typed) fields to their JSON shape at
        construction — tuples nested inside ``config``/``params`` dicts
        become lists — so ``from_manifest(to_manifest(spec)) == spec``
        holds even for specs built with Python tuples."""
        for n in names:
            v = getattr(self, n)
            if v is not None:
                object.__setattr__(self, n, _jsonable(v))

    @classmethod
    def _spec_fields(cls) -> List[dataclasses.Field]:
        return [f for f in dataclasses.fields(cls)
                if f.name != "name" and f.metadata.get("manifest", True)]

    def to_manifest(self) -> Dict[str, Any]:
        spec = {f.name: _jsonable(getattr(self, f.name))
                for f in self._spec_fields()}
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "metadata": {"name": self.name}, "spec": spec}

    def to_json(self, *, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_manifest(), indent=indent)

    @classmethod
    def _from_spec(cls, name: str, spec: Mapping[str, Any]):
        hints = typing.get_type_hints(cls)
        known = {f.name: f for f in cls._spec_fields()}
        kwargs: Dict[str, Any] = {"name": name}
        for key, value in spec.items():
            if key not in known:
                raise ManifestError(
                    f"unknown field for kind {cls.KIND!r}; known: "
                    f"{sorted(known)}", field=f"spec.{key}")
            kwargs[key] = _coerce(f"spec.{key}", value, hints[key])
        for f in known.values():
            if f.name not in kwargs and \
                    f.default is dataclasses.MISSING and \
                    f.default_factory is dataclasses.MISSING:
                raise ManifestError("required field missing",
                                    field=f"spec.{f.name}")
        return cls(**kwargs)


@dataclass(frozen=True)
class TrainJob(WorkloadResource):
    """Self-healing elastic training (routes to
    ``repro_torch.elastic``; the fabric and tenant backends of the JAX
    package are not ported yet)."""

    KIND: ClassVar[str] = "TrainJob"

    name: str
    steps: int
    arch: str = "phi4-mini-3.8b"
    smoke: bool = True
    seq_len: int = 64
    global_batch: int = 4
    base_shape: Tuple[int, int] = (1, 1)
    max_data: Optional[int] = 1
    ckpt_dir: str = ""                  # "" = trainer-owned throwaway store
    ckpt_every: int = 0
    keep: Optional[int] = 2
    log_every: int = 10
    # optimizer steps a chunk (one train_chunk call); ckpt/log cadences
    # snap UP to multiples, preemption latency is bounded by one chunk
    # (see repro_torch.elastic.ElasticTrainSpec)
    device_steps: int = 1
    fail_at: int = -1                   # inject ONE crash at this step
    seed: int = 0
    data_seed: int = 17
    rejoin_timeout_s: float = 60.0
    verbose: bool = True
    namespace: Optional[str] = None     # default: "elastic" / the tenant's
    # model / optimizer overrides: kwargs for ModelConfig / the launch
    # schedule defaults (lr, warmup_steps, decay_steps, ...)
    config: Optional[Dict[str, Any]] = None
    optimizer: Optional[Dict[str, Any]] = None
    # tenant / fabric routing
    site: Optional[str] = None          # tenant backend: claim site
    devices: Optional[int] = None       # tenant backend: claim size
    min_devices: Optional[int] = None   # tenant backend: claim floor

    def __post_init__(self):
        self._canonicalize("config", "optimizer")
        _require(bool(self.name), "must be a non-empty string",
                 "metadata.name")
        _require(self.steps >= 1, "must be >= 1", "spec.steps")
        _require(self.seq_len >= 1, "must be >= 1", "spec.seq_len")
        _require(self.global_batch >= 1, "must be >= 1",
                 "spec.global_batch")
        _require(len(self.base_shape) == 2 and
                 all(s >= 1 for s in self.base_shape),
                 "must be two positive ints (data, model)",
                 "spec.base_shape")
        _require(self.ckpt_every >= 0, "must be >= 0", "spec.ckpt_every")
        _require(self.device_steps >= 1, "must be >= 1",
                 "spec.device_steps")
        _require(self.devices is None or self.devices >= 1,
                 "must be >= 1 when set", "spec.devices")


@dataclass(frozen=True)
class ServeJob(WorkloadResource):
    """Continuous-batching inference over a request queue (routes to
    ``repro_torch.serving.ServingEngine``, or with ``max_replicas > 1``
    to replicas behind the router)."""

    KIND: ClassVar[str] = "ServeJob"

    name: str
    arch: str = "phi4-mini-3.8b"
    smoke: bool = True
    n_requests: int = 8                 # synthetic stream when no requests
    prompt_len: int = 32
    max_new_tokens: int = 16
    slots: int = 4                      # decode-slot pool size
    seed: int = 0
    gen_lens: Optional[Tuple[int, ...]] = None   # heterogeneous stops
    lease_timeout: float = 30.0
    warmup: bool = False
    # explicit request stream: [{"id": ..., "prompt": [...], ...}, ...]
    requests: Optional[List[Dict[str, Any]]] = None
    site: Optional[str] = None          # tenant/fabric routing
    # paged KV pool + prefix cache (None = auto when the family supports it)
    paged: Optional[bool] = None
    block_size: int = 8
    pool_blocks: Optional[int] = None
    prefix_cache: bool = True
    # multi-replica serving: min==max pins the fleet size; min<max enables
    # the HPA-style autoscaler (serving.router) between the bounds
    min_replicas: int = 1
    max_replicas: int = 1
    target_backlog: float = 4.0         # autoscaler queue depth / replica
    ttft_slo_s: Optional[float] = None  # p99 service-TTFT scale-up trigger

    def __post_init__(self):
        self._canonicalize("requests")
        _require(bool(self.name), "must be a non-empty string",
                 "metadata.name")
        _require(self.slots >= 1, "must be >= 1", "spec.slots")
        _require(self.prompt_len >= 1, "must be >= 1", "spec.prompt_len")
        _require(self.max_new_tokens >= 1, "must be >= 1",
                 "spec.max_new_tokens")
        _require(self.n_requests >= 0, "must be >= 0", "spec.n_requests")
        _require(self.block_size >= 1, "must be >= 1", "spec.block_size")
        _require(self.pool_blocks is None or self.pool_blocks >= 2,
                 "must be >= 2 (one data block + the null block)",
                 "spec.pool_blocks")
        _require(1 <= self.min_replicas <= self.max_replicas,
                 "need 1 <= min_replicas <= max_replicas",
                 "spec.min_replicas")
        _require(self.target_backlog > 0, "must be > 0",
                 "spec.target_backlog")
        if self.gen_lens is not None:
            _require(len(self.gen_lens) > 0 and
                     all(g >= 1 for g in self.gen_lens),
                     "must be a non-empty list of ints >= 1",
                     "spec.gen_lens")
        if self.requests is not None:
            for i, r in enumerate(self.requests):
                _require(isinstance(r, Mapping) and "id" in r and
                         "prompt" in r,
                         "each request needs 'id' and 'prompt'",
                         f"spec.requests[{i}]")


@dataclass(frozen=True)
class BatchJob(WorkloadResource):
    """A plain orchestrator Job: N pod replicas running one function.

    The function arrives either as a runtime callable (``fn``, excluded
    from manifests) or declaratively as ``entrypoint`` —
    ``"pkg.module:attr"`` resolved at apply time and called as
    ``fn(ctx)`` (or ``fn(ctx, **params)`` when ``params`` is set)."""

    KIND: ClassVar[str] = "BatchJob"

    name: str
    replicas: int = 1
    devices_per_pod: int = 0
    backoff_limit: int = 3
    priority: Optional[int] = None
    namespace: Optional[str] = None
    site: Optional[str] = None          # tenant/fabric routing
    entrypoint: Optional[str] = None
    params: Optional[Dict[str, Any]] = None
    fn: Optional[Callable] = _runtime_field()

    def __post_init__(self):
        self._canonicalize("params")
        _require(bool(self.name), "must be a non-empty string",
                 "metadata.name")
        _require(self.replicas >= 1, "must be >= 1", "spec.replicas")
        _require(self.devices_per_pod >= 0, "must be >= 0",
                 "spec.devices_per_pod")
        _require(self.backoff_limit >= 0, "must be >= 0",
                 "spec.backoff_limit")
        if self.entrypoint is not None:
            _require(":" in self.entrypoint,
                     "must look like 'pkg.module:attr'", "spec.entrypoint")

    def resolve_fn(self) -> Callable:
        if self.fn is not None:
            fn = self.fn
        elif self.entrypoint is not None:
            fn = resolve_entrypoint(self.entrypoint)
        else:
            raise ManifestError(
                "BatchJob needs a runtime fn or a declarative entrypoint",
                field="spec.entrypoint")
        if self.params:
            params = dict(self.params)
            return lambda ctx: fn(ctx, **params)
        return fn


@dataclass(frozen=True)
class WorkflowRun(WorkloadResource):
    """A measured, resumable step DAG (routes to
    ``repro_torch.core.workflow.Workflow`` on the session's backend).

    Steps arrive as a runtime ``define(wf, **params)`` callable (excluded
    from manifests), declaratively via ``entrypoint`` (a
    ``"pkg.module:attr"`` path), or as a workflow *program*: a declarative
    ``graph`` of nodes with deps / ``when:`` conditionals / ``repeat:``
    loops / ``scatter:`` fan-out / nested subworkflows, compiled and run
    concurrently by ``repro_torch.flow`` (``max_workers`` bounds the
    branch pool)."""

    KIND: ClassVar[str] = "WorkflowRun"

    name: str
    namespace: Optional[str] = None
    resume: bool = True
    only: Optional[str] = None          # run a single step in isolation
    entrypoint: Optional[str] = None
    params: Optional[Dict[str, Any]] = None
    graph: Optional[Dict[str, Any]] = None
    max_workers: int = 8                # graph mode: branch pool bound
    define: Optional[Callable] = _runtime_field()

    def __post_init__(self):
        self._canonicalize("params", "graph")
        _require(bool(self.name), "must be a non-empty string",
                 "metadata.name")
        if self.entrypoint is not None:
            _require(":" in self.entrypoint,
                     "must look like 'pkg.module:attr'", "spec.entrypoint")
        _require(isinstance(self.max_workers, int) and
                 not isinstance(self.max_workers, bool) and
                 self.max_workers >= 1,
                 "must be an integer >= 1", "spec.max_workers")
        if self.graph is not None:
            _require(self.entrypoint is None and self.define is None,
                     "a graph workflow cannot also set entrypoint/define",
                     "spec.graph")
            # eager shape validation: bad graphs fail at apply time with
            # a field-naming ManifestError, not mid-run (lazy import —
            # repro_torch.flow imports resolve_entrypoint from this module)
            from repro_torch.flow.spec import validate_graph
            validate_graph(self.graph, field="spec.graph")

    def resolve_define(self) -> Callable:
        if self.define is not None:
            fn = self.define
        elif self.entrypoint is not None:
            fn = resolve_entrypoint(self.entrypoint)
        else:
            raise ManifestError(
                "WorkflowRun needs a runtime define or a declarative "
                "entrypoint", field="spec.entrypoint")
        if self.params:
            params = dict(self.params)
            return lambda wf: fn(wf, **params)
        return fn


@dataclass(frozen=True)
class RLJob(WorkloadResource):
    """Distributed RL: a serving-plane actor fleet feeding an elastic
    policy-gradient learner (routes to ``repro_torch.rl``).

    ``actors`` ServingEngine replicas lease rollout tickets from one
    shared work queue, push version-stamped trajectories into a leased
    replay buffer, and pull fresh weights from a versioned policy store
    every ``broadcast_every`` learner steps.  The learner drains
    ``rollouts_per_step`` trajectories per optimizer step, never trains
    on rollouts staler than ``max_policy_lag`` weight versions (stale
    ones are dropped and metered), and checkpoint-resumes across
    preemption with the replay queue snapshot riding in the manifest."""

    KIND: ClassVar[str] = "RLJob"

    name: str
    learner_steps: int
    arch: str = "phi4-mini-3.8b"
    smoke: bool = True
    actors: int = 2                     # rollout fleet width
    rollouts_per_step: int = 2          # learner batch (trajectories/step)
    prompt_len: int = 8
    max_new_tokens: int = 8
    seq_len: int = 32                   # learner sequence budget
    slots: int = 2                      # decode-slot pool per actor
    max_policy_lag: int = 2             # bounded-staleness contract
    broadcast_every: int = 2            # learner steps between publishes
    ckpt_every: int = 2
    device_steps: int = 1               # fused optimizer steps per dispatch
    keep: int = 3
    seed: int = 0
    fail_at: int = -1                   # inject ONE learner crash here
    lease_timeout: float = 30.0
    ckpt_dir: str = ""                  # "" = job-owned throwaway store
    # model / optimizer overrides (kwargs for ModelConfig / the schedule)
    config: Optional[Dict[str, Any]] = None
    optimizer: Optional[Dict[str, Any]] = None
    # paged KV pool on the actor engines
    paged: Optional[bool] = None
    block_size: int = 8
    pool_blocks: Optional[int] = None
    prefix_cache: bool = True
    # tenant / fabric routing: actors serve at `site`, the learner trains
    # at `learner_site` (default: same site), weights cross the fabric
    site: Optional[str] = None
    learner_site: Optional[str] = None
    devices: Optional[int] = None       # tenant backend: actor claim size
    min_devices: Optional[int] = None   # tenant backend: actor claim floor

    def __post_init__(self):
        self._canonicalize("config", "optimizer")
        _require(bool(self.name), "must be a non-empty string",
                 "metadata.name")
        _require(self.learner_steps >= 1, "must be >= 1",
                 "spec.learner_steps")
        _require(self.actors >= 1, "must be >= 1", "spec.actors")
        _require(self.rollouts_per_step >= 1, "must be >= 1",
                 "spec.rollouts_per_step")
        _require(self.prompt_len >= 1, "must be >= 1", "spec.prompt_len")
        _require(self.max_new_tokens >= 1, "must be >= 1",
                 "spec.max_new_tokens")
        _require(self.seq_len >= 2, "must be >= 2 (one shifted pair)",
                 "spec.seq_len")
        _require(self.slots >= 1, "must be >= 1", "spec.slots")
        _require(self.max_policy_lag >= 0, "must be >= 0",
                 "spec.max_policy_lag")
        _require(self.broadcast_every >= 1, "must be >= 1",
                 "spec.broadcast_every")
        _require(self.ckpt_every >= 0, "must be >= 0", "spec.ckpt_every")
        _require(self.device_steps >= 1, "must be >= 1",
                 "spec.device_steps")
        _require(self.keep >= 1, "must be >= 1", "spec.keep")
        _require(self.lease_timeout > 0, "must be > 0",
                 "spec.lease_timeout")
        _require(self.block_size >= 1, "must be >= 1", "spec.block_size")
        _require(self.pool_blocks is None or self.pool_blocks >= 2,
                 "must be >= 2 (one data block + the null block)",
                 "spec.pool_blocks")
        _require(self.devices is None or self.devices >= 1,
                 "must be >= 1 when set", "spec.devices")


KINDS: Dict[str, Type[WorkloadResource]] = {
    cls.KIND: cls
    for cls in (TrainJob, ServeJob, BatchJob, WorkflowRun, RLJob)}

WorkloadSpec = Union[TrainJob, ServeJob, BatchJob, WorkflowRun, RLJob]


# ------------------------------------------------------------- entrypoints
def from_manifest(manifest: Mapping[str, Any]) -> WorkloadSpec:
    """Parse + validate one manifest dict into a typed workload spec."""
    if not isinstance(manifest, Mapping):
        raise ManifestError(
            f"manifest must be an object, got {type(manifest).__name__}")
    version = manifest.get("apiVersion", API_VERSION)
    _require(version == API_VERSION,
             f"unsupported version {version!r}; this build speaks "
             f"{API_VERSION!r}", "apiVersion")
    kind = manifest.get("kind")
    if kind not in KINDS:
        raise ManifestError(
            f"unknown kind {kind!r}; known kinds: {sorted(KINDS)}",
            field="kind")
    meta = manifest.get("metadata") or {}
    _require(isinstance(meta, Mapping), "must be an object", "metadata")
    name = meta.get("name")
    _require(isinstance(name, str) and bool(name),
             "required field missing (a non-empty string)",
             "metadata.name")
    spec = manifest.get("spec") or {}
    _require(isinstance(spec, Mapping), "must be an object", "spec")
    return KINDS[kind]._from_spec(name, spec)


def from_json(text: str) -> WorkloadSpec:
    try:
        manifest = json.loads(text)
    except json.JSONDecodeError as e:
        raise ManifestError(f"manifest is not valid JSON: {e}") from e
    return from_manifest(manifest)


def load_manifest(path: str) -> WorkloadSpec:
    """Read + parse a manifest file (JSON — the kubectl-YAML analogue)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return from_json(text)
