"""The CONNECT workflow — the paper's §III case study, end to end.

Four steps, exactly the paper's Fig. 2 / Table I structure:

  1. download   N queue-fed worker pods "download" (synthesize) MERRA-like
                IVT chunks into the ObjectStore (THREDDS -> Ceph; Figs 3-4).
  2. train      one device trains the FFN 3-D CNN on labeled subvolumes
                (paper: 1 GPU, 306 min; Fig 5); the model is saved.
  3. inference  M worker pods lease chunks from a queue, run flood-fill
                segmentation, write masks (paper: 50 GPUs, Fig 6) —
                work-stealing == straggler mitigation.
  4. analyze    CONNECT labeling (time+space connected objects) + object
                life-cycle statistics (the JupyterLab step).

A port of the JAX package's ``apps/connect/pipeline.py`` with the same
names, store keys and file formats: the chunks, the model (one
``models/ffn/<leaf>.npy`` a leaf, f32 in the JAX layout DHWIO), the masks
and the step markers are the reference's bytes, so a run started by
either stack is finished by the other, and a model trained by either
segments in the other.

Devices: a step computes on its own cluster's ``compute_device`` (the
session's card under the cluster backend; the fabric's device, or the
site cluster's own device, at a federation site), never on a global
default.  Training draws its init through ``params.init_params`` from a
``torch.Generator`` seeded with ``cc.seed`` (the draw differs from
``jax.random``'s).  The convolutions run in f32 with deterministic
algorithms (``ffn3d.reference_convs``).
Inference runs in worker threads, and grad mode is per thread, so the
inference function enters ``torch.inference_mode`` itself.
"""
from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.apps.connect import segment
from repro_torch.core.metrics import Registry
from repro_torch.core.orchestrator import Cluster
from repro_torch.core.queue import WorkQueue, run_workers
from repro_torch.core.workflow import Step, StepCtx, Workflow
from repro_torch.data import volumes
from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device
from repro_torch.models import ffn3d
from repro_torch.models import params as pr


@dataclass(frozen=True)
class ConnectConfig:
    n_chunks: int = 4
    download_workers: int = 4
    inference_workers: int = 4
    vol: volumes.VolumeSpec = field(default_factory=volumes.VolumeSpec)
    ffn: ffn3d.FFNConfig = field(default_factory=ffn3d.FFNConfig)
    train_steps: int = 60
    train_batch: int = 4
    lr: float = 3e-3
    seed: int = 0


# ---------------------------------------------------------------------------
# step 1: queue-fed "download" (paper: THREDDS -> Redis queue -> aria2 pods)
# ---------------------------------------------------------------------------

def step_download(ctx: StepCtx, cc: ConnectConfig):
    keys = volumes.chunk_keys(cc.n_chunks)
    queue = WorkQueue(list(enumerate(keys)), lease_timeout=60.0)
    t0 = time.perf_counter()
    total = {"bytes": 0}
    lock = threading.Lock()
    # Federated run (repro_torch.fabric): each chunk lands at its "nearest
    # THREDDS mirror" — scattered round-robin across live sites, with one
    # off-site replica so a single site loss never strands the raw data.
    # Single-cluster run: ctx.store has no fabric and writes stay local.
    fed = getattr(ctx.store, "fed", None)
    sites = [s.name for s in fed.fabric.up_sites()] if fed is not None else []

    def fetch(item):
        cid, key = item
        ivt, labels = volumes.generate_chunk(cc.vol, cid)
        if sites:
            home = fed.view(sites[cid % len(sites)])
            n = home.put_array(f"{key}/ivt.npy", ivt)
            n += home.put_array(f"{key}/labels.npy", labels)
            if len(sites) > 1:
                mirror = sites[(cid + 1) % len(sites)]
                for k in (f"{key}/ivt.npy", f"{key}/labels.npy"):
                    fed.replicate(k, mirror)
        else:
            n = ctx.store.put_array(f"{key}/ivt.npy", ivt)
            n += ctx.store.put_array(f"{key}/labels.npy", labels)
        ctx.metrics.inc("download/bytes", n)
        with lock:
            total["bytes"] += n
        return key

    done = run_workers(queue, fetch, cc.download_workers, name="dl")
    dt = time.perf_counter() - t0
    ctx.report.pods = cc.download_workers
    ctx.report.cpus = cc.download_workers
    ctx.report.data_processed_bytes = total["bytes"]
    ctx.metrics.gauge("download/throughput_MBs",
                      total["bytes"] / 2**20 / max(dt, 1e-9))
    return {"chunks": done, "bytes": total["bytes"]}


# ---------------------------------------------------------------------------
# step 2: FFN training (paper: single GPU, Tensorflow; here: one device)
# ---------------------------------------------------------------------------

def step_train(ctx: StepCtx, cc: ConnectConfig):
    return _train_ffn(ctx, cc, volumes.chunk_keys(cc.n_chunks)[0])


def train_windows(store: ObjectStore, cc: ConnectConfig, key0: str):
    """The FFN's training windows of chunk ``key0``: fov-sized windows at
    half-fov strides, the half with the most object voxels kept."""
    ivt = store.get_array(f"{key0}/ivt.npy")
    labels = store.get_array(f"{key0}/labels.npy")
    subs = volumes.subvolumes(ivt, labels, cc.ffn.fov,
                              tuple(max(f // 2, 1) for f in cc.ffn.fov))
    xs = np.stack([s[0] for s in subs])
    ys = np.stack([s[1] for s in subs])
    # keep windows that contain some object (FFN seeds on objects)
    frac = ys.mean(axis=(1, 2, 3))
    keep = np.argsort(-frac)[:max(8, len(subs) // 2)]
    return xs[keep], ys[keep]


def _train_ffn(ctx: StepCtx, cc: ConnectConfig, key0: str):
    dev = ctx.cluster.compute_device
    xs, ys = train_windows(ctx.store, cc, key0)

    schema = ffn3d.ffn_schema(cc.ffn)
    params = pr.init_params(
        schema, torch.Generator(device=dev).manual_seed(cc.seed),
        "float32", dev)
    names = sorted(params)
    leaves = [params[k].requires_grad_(True) for k in names]

    def train_step(x, y):
        loss = ffn3d.bce_loss(cc.ffn, params, x, y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads))
            scale = torch.clamp_max(1.0 / torch.clamp_min(gnorm, 1e-9), 1.0)
            for p, g in zip(leaves, grads):
                p.sub_(cc.lr * scale * g)
        return loss.detach()

    rng = np.random.RandomState(cc.seed)
    losses = []
    with ffn3d.reference_convs():
        for _ in range(cc.train_steps):
            idx = rng.randint(0, len(xs), cc.train_batch)
            loss = train_step(torch.as_tensor(xs[idx], device=dev),
                              torch.as_tensor(ys[idx], device=dev))
            losses.append(float(loss))
            ctx.metrics.gauge("ffn_train/loss", losses[-1])
    # persist the trained model (paper: model saved to Ceph for inference)
    for name in names:
        ctx.store.put_array(f"models/ffn/{name}.npy",
                            params[name].detach().cpu().numpy())
    ctx.report.devices = 1
    ctx.report.data_processed_bytes = xs.nbytes
    ctx.report.memory_bytes = xs.nbytes + ys.nbytes
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "n_windows": int(len(xs))}


def _load_ffn_params(store: ObjectStore, cc: ConnectConfig, device="cuda"):
    dev = resolve_device(device)
    return {name: torch.as_tensor(
                store.get_array(f"models/ffn/{name}.npy"), device=dev)
            for name, _ in pr.leaves(ffn3d.ffn_schema(cc.ffn))}


# ---------------------------------------------------------------------------
# step 3: distributed inference (paper: 50 GPUs, queue of data shards)
# ---------------------------------------------------------------------------

def _ffn_infer(cc: ConnectConfig, params):
    dev = params["stem"].device

    def infer(x):   # x (B,ft,fy,fx) -> bool mask on the params' device
        with torch.inference_mode(), ffn3d.reference_convs():
            x = torch.as_tensor(x, device=dev)
            return torch.sigmoid(ffn3d.flood_fill(cc.ffn, params, x)) > 0.5
    return infer


def _chunk_mask(ctx: StepCtx, cc: ConnectConfig, infer, key: str) -> int:
    """Segment ONE IVT chunk: tile into FOV windows (stride = fov, no
    overlap; the reference's tiling, which leaves the remainders past the
    last whole window at 0), flood-fill each, write the mask.  Returns
    voxels masked."""
    ft, fy, fx = cc.ffn.fov
    ivt = ctx.store.get_array(f"{key}/ivt.npy")
    T, LA, LO = ivt.shape
    tiles, coords = [], []
    for t in range(0, T - ft + 1, ft):
        for y in range(0, LA - fy + 1, fy):
            for x in range(0, LO - fx + 1, fx):
                tiles.append(ivt[t:t + ft, y:y + fy, x:x + fx])
                coords.append((t, y, x))
    mask = np.zeros_like(ivt, dtype=np.uint8)
    bs = 8
    for i in range(0, len(tiles), bs):
        batch = np.stack(tiles[i:i + bs])
        pred = infer(batch).cpu().numpy()
        for j, (t, y, x) in enumerate(coords[i:i + bs]):
            mask[t:t + ft, y:y + fy, x:x + fx] = pred[j]
    ctx.store.put_array(f"{key}/mask.npy", mask)
    ctx.metrics.inc("inference/voxels", mask.size)
    return int(mask.size)


def step_inference(ctx: StepCtx, cc: ConnectConfig):
    params = _load_ffn_params(ctx.store, cc, ctx.cluster.compute_device)
    keys = volumes.chunk_keys(cc.n_chunks)
    queue = WorkQueue(list(keys), lease_timeout=300.0)
    infer = _ffn_infer(cc, params)
    t0 = time.perf_counter()
    voxels = {"n": 0}
    lock = threading.Lock()

    def run_chunk(key):
        n = _chunk_mask(ctx, cc, infer, key)
        with lock:
            voxels["n"] += n
        return key

    done = run_workers(queue, run_chunk, cc.inference_workers, name="infer")
    dt = time.perf_counter() - t0
    ctx.report.pods = cc.inference_workers
    ctx.report.devices = cc.inference_workers
    ctx.report.data_processed_bytes = voxels["n"] * 4
    ctx.metrics.gauge("inference/voxels_per_s", voxels["n"] / max(dt, 1e-9))
    return {"chunks": done, "voxels": voxels["n"]}


# ---------------------------------------------------------------------------
# step 4: CONNECT labeling + life-cycle stats (the JupyterLab step)
# ---------------------------------------------------------------------------

def step_analyze(ctx: StepCtx, cc: ConnectConfig):
    return _analyze_keys(ctx, volumes.chunk_keys(cc.n_chunks))


def _analyze_keys(ctx: StepCtx, keys: List[str]):
    dev = ctx.cluster.compute_device
    all_stats = []
    for key in keys:
        mask = ctx.store.get_array(f"{key}/mask.npy")
        labels = segment.connect_label(
            torch.as_tensor(mask, device=dev)).cpu().numpy()
        stats = segment.object_stats(labels)
        ctx.store.put_json(f"{key}/objects.json", stats)
        all_stats.extend(stats)
    ctx.report.data_processed_bytes = sum(
        ctx.store.size(f"{k}/mask.npy") for k in keys)
    n_obj = len(all_stats)
    ctx.metrics.gauge("analyze/objects", n_obj)
    longest = max((s["duration"] for s in all_stats), default=0)
    return {"objects": n_obj, "longest_lifecycle": longest}


# ---------------------------------------------------------------------------

def dataset_keys(cc: ConnectConfig) -> Dict[str, List[str]]:
    """The pipeline's dataset keys, per kind — what federated placement
    scores (which site holds the IVT chunks / model / masks)."""
    keys = volumes.chunk_keys(cc.n_chunks)
    return {"ivt": [f"{k}/ivt.npy" for k in keys],
            "labels": [f"{k}/labels.npy" for k in keys],
            "masks": [f"{k}/mask.npy" for k in keys],
            "model": ["models/ffn/*"]}


def _tupled(d: dict) -> dict:
    """JSON round-trips turn tuple fields (``fov``) into lists; restore
    tuples so dataclass configs hash/compare/unpack as designed."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def connect_config(**kw) -> ConnectConfig:
    """ConnectConfig from plain (manifest-shaped) kwargs: nested ``vol``
    / ``ffn`` dicts become their dataclasses."""
    if isinstance(kw.get("vol"), dict):
        kw["vol"] = volumes.VolumeSpec(**_tupled(kw["vol"]))
    if isinstance(kw.get("ffn"), dict):
        kw["ffn"] = ffn3d.FFNConfig(**_tupled(kw["ffn"]))
    return ConnectConfig(**kw)


def add_connect_steps(wf: Workflow, cc=None, **kw) -> Workflow:
    """Attach the paper's 4-step CONNECT DAG to an existing workflow.

    This is the ``repro_torch.api.WorkflowRun`` entrypoint
    (``"repro_torch.apps.connect.pipeline:add_connect_steps"``): ``cc``
    may be a ConnectConfig, a manifest-shaped dict, or omitted — leftover
    kwargs feed ``connect_config`` so a pure-JSON manifest can size the
    run."""
    if cc is None:
        cc = connect_config(**kw)
    elif isinstance(cc, dict):
        cc = connect_config(**{**cc, **kw})
    ds = dataset_keys(cc)
    wf.add(Step("download", lambda ctx: step_download(ctx, cc),
                pods=cc.download_workers,
                outputs=ds["ivt"] + ds["labels"]))
    wf.add(Step("train", lambda ctx: step_train(ctx, cc), deps=["download"],
                inputs=[ds["ivt"][0], ds["labels"][0]], outputs=ds["model"]))
    wf.add(Step("inference", lambda ctx: step_inference(ctx, cc),
                deps=["train"], pods=cc.inference_workers,
                inputs=ds["ivt"] + ds["model"], outputs=ds["masks"]))
    wf.add(Step("analyze", lambda ctx: step_analyze(ctx, cc),
                deps=["inference"], inputs=ds["masks"]))
    return wf


# ---------------------------------------------------------------------------
# CONNECT as a workflow *program* (repro_torch.flow): scatter the chunks,
# place each fetch/segment branch at its own site, gather for analysis.
# ---------------------------------------------------------------------------

def _cc_of(inputs) -> ConnectConfig:
    """Every graph node downstream of ``plan`` reads the run's config
    from plan's output manifest — one source of truth, JSON round-trip
    safe (resume reloads it from the store)."""
    return connect_config(**inputs["plan"]["cc"])


def g_plan(ctx: StepCtx, **kw):
    cc = connect_config(**kw)
    return {"chunks": volumes.chunk_keys(cc.n_chunks), "cc": asdict(cc)}


def g_fetch(ctx: StepCtx):
    """One scatter branch of the download: synthesize ONE IVT chunk at
    whichever site the planner placed this branch (THREDDS mirror
    analogue — the data homes where it lands)."""
    cc = _cc_of(ctx.inputs)
    cid, key = ctx.inputs["index"], ctx.inputs["item"]
    ivt, labels = volumes.generate_chunk(cc.vol, cid)
    n = ctx.store.put_array(f"{key}/ivt.npy", ivt)
    n += ctx.store.put_array(f"{key}/labels.npy", labels)
    ctx.metrics.inc("download/bytes", n)
    ctx.report.data_processed_bytes = n
    return {"chunk": key, "bytes": n}


def g_train(ctx: StepCtx):
    cc = _cc_of(ctx.inputs)
    return _train_ffn(ctx, cc, ctx.inputs["plan"]["chunks"][0])


def g_segment(ctx: StepCtx):
    """One scatter branch of distributed inference: flood-fill ONE chunk
    (paper's 50-GPU fan-out, here one placed step per chunk)."""
    cc = _cc_of(ctx.inputs)
    params = _load_ffn_params(ctx.store, cc, ctx.cluster.compute_device)
    key = ctx.inputs["item"]
    voxels = _chunk_mask(ctx, cc, _ffn_infer(cc, params), key)
    ctx.report.devices = 1
    ctx.report.data_processed_bytes = voxels * 4
    return {"chunk": key, "voxels": voxels}


def g_analyze(ctx: StepCtx):
    return _analyze_keys(ctx, ctx.inputs["plan"]["chunks"])


def connect_graph(**kw) -> dict:
    """The CONNECT pipeline as a five-node declarative workflow program
    (the ``WorkflowRun.spec.graph`` shape): plan -> fetch (scatter over
    chunks) -> train -> segment (scatter over chunks, placed at the
    data) -> analyze (gather).  ``kw`` are ``connect_config`` fields and
    ride in plan's params."""
    ep = "repro_torch.apps.connect.pipeline"
    return {"nodes": [
        {"step": "plan", "entrypoint": f"{ep}:g_plan", "params": kw},
        {"step": "fetch", "deps": ["plan"], "entrypoint": f"{ep}:g_fetch",
         "scatter": {"over": "plan.chunks"},
         "outputs": ["{item}/ivt.npy", "{item}/labels.npy"]},
        {"step": "train", "deps": ["plan", "fetch"],
         "entrypoint": f"{ep}:g_train",
         "inputs": ["merra/ivt/chunk_00000/*"],
         "outputs": ["models/ffn/*"]},
        {"step": "segment", "deps": ["plan", "train"],
         "entrypoint": f"{ep}:g_segment",
         "scatter": {"over": "plan.chunks"},
         "inputs": ["{item}/ivt.npy", "models/ffn/*"],
         "outputs": ["{item}/mask.npy"]},
        {"step": "analyze", "deps": ["plan", "segment"],
         "entrypoint": f"{ep}:g_analyze"},
    ]}


def build_workflow(cluster: Optional[Cluster] = None,
                   store: Optional[ObjectStore] = None,
                   cc: Optional[ConnectConfig] = None,
                   metrics: Optional[Registry] = None,
                   planner=None) -> Workflow:
    wf = Workflow("connect", cluster=cluster, store=store, metrics=metrics,
                  namespace="atmos-science", planner=planner)
    return add_connect_steps(wf, cc or ConnectConfig())


def run_connect_workflow(root: str, cc: Optional[ConnectConfig] = None,
                         device="cuda"):
    cluster = Cluster(devices=[resolve_device(device)])
    cluster.create_namespace("atmos-science")
    store = ObjectStore(root)
    wf = build_workflow(cluster, store, cc)
    results = wf.run()
    return wf, results
