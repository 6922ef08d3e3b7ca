"""Atomic, async checkpointing with auto-resume, in the JAX package's layout.

A port of the JAX package's ``checkpoint/checkpoint.py``.  A checkpoint of
the same state is the same files, byte for byte, on either side, so a run
can stop under one stack and resume under the other:

  * one ``.npy`` a leaf at ``<prefix>/step_%010d/<key, / as .>/shard0.npy``,
    keys named as JAX's ``tree_flatten_with_path`` names them over nested
    dicts (keys sorted at every level: ``params/blocks/0_attn/wq``);
  * a dtype numpy lacks (bfloat16, float8) is stored as the unsigned
    integer of its width; the manifest keeps the true dtype's numpy name
    (``"bfloat16"``, never ``"torch.bfloat16"``);
  * atomic: ``MANIFEST.json`` is written last, through the ObjectStore's
    tmp + rename, and is the commit point; GC deletes it first;
  * async: ``save_async`` copies every leaf to the host before it returns
    (the port's AdamW updates params and moments in place, so a later
    copy could mix two steps) and writes in a background thread;
  * resume: ``restore`` casts each leaf to the abstract tree's dtype and
    places it on an explicit device;
  * GC: ``keep=N`` keeps the newest N, ``keep=0`` none, ``keep=None``
    turns GC off.

Across ranks (``mesh=``, a ``launch.mesh.RankMesh``; ``par``, the layout;
``schema``, the state's ``PSpec`` tree, whose logical axes ``par``'s
rules lay out) the files stay the same: one whole leaf a ``shard0.npy``,
readable by the JAX package.  A save gathers each leaf's blocks over the
world, one leaf at a time, and rank 0 puts it back together
(``sharding.specs.assemble``) and copies it to the host: the gather is
the synchronous snapshot; rank 0 alone writes, in its background thread
under ``save_async``, and alone runs GC.  ``wait`` on every rank returns
only after rank 0's manifest has committed (and raises on every rank if
its write failed), so no rank can pick a step that has not.  A restore
onto any mesh, the counterpart of the reference's ``device_put`` onto
shardings of a mesh other than the saver's, reads the manifest and each
whole leaf on every rank and keeps the block ``specs.local_shard`` cuts
for the rank, on its device; ``restore_latest`` takes the step rank 0
picks, on every rank.

``saves`` and ``restores`` record each call's seconds and bytes.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device
from repro_torch.sharding import specs

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_INT = {1: np.int8, 2: np.int16, 4: np.int32}
_TORCH_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32}
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of a nested dict, in JAX's order and with its key
    strings: dict keys sorted at every level, joined by "/"."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(flatten_with_paths(
                tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _unflatten(abstract, fn, prefix: str = ""):
    """``abstract``'s dict structure with each leaf replaced by
    fn(key, leaf)."""
    if isinstance(abstract, dict):
        return {k: _unflatten(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in abstract.items()}
    return fn(prefix, abstract)


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, the manifest's dtype) of one leaf: a copy on the
    host that later in-place updates of ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype.is_floating_point and t.dtype not in _NUMPY_FLOATS:
            t = t.view(_TORCH_INT[t.element_size()])
            arr = t.to("cpu", copy=True).contiguous().numpy()
            return arr.view(_UINT[arr.dtype.itemsize]), name
        return t.to("cpu", copy=True).contiguous().numpy(), name
    arr = np.array(leaf, copy=True)
    name = str(arr.dtype)
    if arr.dtype.kind not in "biufc":
        arr = arr.view(_UINT[arr.dtype.itemsize])
    return arr, name


def _layout(mesh, par, schema) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """key -> (whole shape, spec) of every leaf of ``schema`` as ``par``'s
    rules lay it out on ``mesh`` (a ``launch.mesh.RankMesh``)."""
    if par is None or schema is None:
        raise ValueError("a checkpoint across ranks takes the layout (par) "
                         "and the state's schema")
    rules = specs.logical_rules(par)
    return {key: (tuple(p.shape),
                  specs.spec_for(p.shape, p.axes, mesh.mesh, rules))
            for key, p in flatten_with_paths(schema)}


def _whole(block: torch.Tensor, shape, spec, mesh) -> Optional[torch.Tensor]:
    """The whole leaf from every rank's ``block`` of it, on rank 0 (None
    elsewhere): an all-gather of the blocks' bytes over the world, which
    NCCL and gloo take on the card and gloo on the CPU."""
    import torch.distributed as dist
    if tuple(block.shape) == tuple(shape):          # not split: every rank
        return block if mesh.rank == 0 else None    # holds it whole
    block = block.detach().contiguous()
    parts = [torch.empty_like(block) for _ in range(mesh.world_size)]
    dist.all_gather([p.reshape(-1).view(torch.uint8) for p in parts],
                    block.reshape(-1).view(torch.uint8), group=mesh.world)
    if mesh.rank != 0:
        return None
    # rank r sits at the r-th coordinates in row-major order
    everyone = itertools.product(*(range(n) for n in mesh.mesh.sizes))
    return specs.assemble(dict(zip(everyone, parts)), shape, spec, mesh.mesh)


def gather_whole(tree: Any, mesh, par, schema) -> Optional[Any]:
    """Every rank's blocks of ``tree`` put back together, leaf by leaf, as
    whole tensors on the CPU on rank 0 (None on the other ranks); every
    rank calls it."""
    layout = _layout(mesh, par, schema)
    out = {}
    for key, block in flatten_with_paths(tree):
        whole = _whole(block, *layout[key], mesh)
        if whole is not None:
            out[key] = whole.to("cpu", copy=True)
    if mesh.rank != 0:
        return None
    return _unflatten(tree, lambda key, _leaf: out[key])


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The stored array as a tensor of its true dtype (bit exact)."""
    true = getattr(torch, dtype_name)
    if arr.dtype.kind == "u" and str(arr.dtype) != dtype_name and \
            arr.dtype.itemsize == true.itemsize:
        # extension-dtype roundtrip, through the signed view torch reads
        return torch.from_numpy(arr.view(_INT[arr.dtype.itemsize])).view(true)
    return torch.from_numpy(arr)


class Checkpointer:
    """``keep`` semantics: ``keep=N`` (N>=1) retains the newest N checkpoints
    after every save; ``keep=0`` retains NOTHING (every checkpoint is deleted
    by the GC pass that follows its own save); ``keep=None`` disables GC."""

    def __init__(self, store: ObjectStore, prefix: str = "checkpoints",
                 keep: Optional[int] = 3):
        self.store = store
        self.prefix = prefix
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None                 # the ranks of the save in flight
        # one entry a committed save: step, snapshot_s (the host copy),
        # write_s (files, manifest and GC), bytes
        self.saves: List[Dict[str, float]] = []
        # one entry a restore: step, seconds (read + cast + place), bytes
        self.restores: List[Dict[str, float]] = []

    # ----------------------------------------------------------------- save
    def _step_dir(self, step: int) -> str:
        return f"{self.prefix}/step_{step:010d}"

    @staticmethod
    def _snapshot(tree: Any, mesh=None, par=None, schema=None):
        """(key, host array, dtype name) of every leaf (on rank 0 alone
        across ranks; an empty list elsewhere), and the seconds taken."""
        t0 = time.perf_counter()
        if mesh is None:
            leaves = [(key, *_host_leaf(leaf))
                      for key, leaf in flatten_with_paths(tree)]
            return leaves, time.perf_counter() - t0
        layout = _layout(mesh, par, schema)
        leaves = []
        for key, block in flatten_with_paths(tree):
            whole = _whole(block, *layout[key], mesh)
            if whole is not None:
                leaves.append((key, *_host_leaf(whole)))
            del whole
        return leaves, time.perf_counter() - t0

    def _write(self, step: int, leaves, extra: Optional[Dict],
               snapshot_s: float) -> None:
        t0 = time.perf_counter()
        base = self._step_dir(step)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for key, arr, true_dtype in leaves:
            shard_key = f"{base}/{key.replace('/', '.')}/shard0.npy"
            self.store.put_array(shard_key, arr)
            manifest["leaves"].append({
                "key": key, "shards": [shard_key],
                "shape": list(arr.shape), "dtype": true_dtype})
        # manifest written LAST == commit point
        self.store.put_json(f"{base}/MANIFEST.json", manifest)
        self._gc()
        self.saves.append({
            "step": step, "snapshot_s": snapshot_s,
            "write_s": time.perf_counter() - t0,
            "bytes": sum(arr.nbytes for _, arr, _ in leaves)})

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, *,
             mesh=None, par=None, schema=None) -> None:
        """Synchronous save + atomic manifest commit + GC (across ranks:
        every rank calls it with its blocks; rank 0 writes)."""
        self.save_async(step, tree, extra, mesh=mesh, par=par, schema=schema)
        self.wait()

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None, *, mesh=None, par=None,
                   schema=None) -> None:
        """Copy every leaf to the host now (across ranks: gather it to rank
        0); write in the background."""
        self.wait()
        leaves, snapshot_s = self._snapshot(tree, mesh, par, schema)
        self._mesh = mesh
        if mesh is not None and mesh.rank != 0:
            return

        def work():
            try:
                self._write(step, leaves, extra, snapshot_s)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Let the save in flight commit.  Across ranks every rank waits
        for rank 0's commit, and every rank raises if its write failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh, self._mesh = self._mesh, None
        err, self._error = self._error, None
        failed = err is not None
        if mesh is not None:
            failed = bool(mesh.from_rank0([failed])[0])
        if err is not None:
            raise err
        if failed:
            raise RuntimeError(f"rank 0's checkpoint write under "
                               f"{self.prefix!r} failed")

    def _gc(self) -> None:
        if self.keep is None:
            return
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else steps:
            base = self._step_dir(s)
            # MANIFEST.json first, the mirror of save()'s write-last
            # commit: a racing reader either sees the manifest (and every
            # shard it names) or skips the step
            self.store.delete(f"{base}/MANIFEST.json")
            for key in self.store.list(base + "/"):
                self.store.delete(key)
        # Orphan sweep: a GC pass killed between the manifest delete and
        # the shard deletes leaves shards all_steps() can never see again.
        # Only manifest-less step dirs OLDER than the newest committed step
        # go; an in-flight save at a newer step stays untouched.
        if not steps:
            return
        newest = steps[-1]
        on_disk = set()
        plen = len(self.prefix) + 1
        for key in self.store.list(self.prefix + "/"):
            name = key[plen:].split("/", 1)[0]
            if name.startswith("step_"):
                try:
                    on_disk.add(int(name.split("_")[1]))
                except ValueError:
                    pass
        for s in on_disk - set(steps):
            if s < newest:
                for key in self.store.list(self._step_dir(s) + "/"):
                    self.store.delete(key)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = set()
        for key in self.store.list(self.prefix):
            if key.endswith("MANIFEST.json"):
                name = key.split("/")[-2]
                steps.add(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, abstract_tree: Any, device="cuda", *,
                mesh=None, par=None, schema=None) -> Any:
        """Rebuild ``abstract_tree``-shaped state (leaves with a torch
        ``dtype``: tensors, or ``meta`` tensors), each leaf cast to its
        abstract leaf's dtype and placed on ``device``; across ranks
        (``mesh``) each rank's block of it, on the rank's device."""
        dev = mesh.device if mesh is not None else resolve_device(device)
        layout = _layout(mesh, par, schema) if mesh is not None else None
        t0 = time.perf_counter()
        manifest = self.store.get_json(f"{self._step_dir(step)}/MANIFEST.json")
        by_key = {entry["key"]: entry for entry in manifest["leaves"]}
        nbytes = 0

        def load(key, ab):
            nonlocal nbytes
            entry = by_key[key]
            arr = self.store.get_array(entry["shards"][0])
            nbytes += arr.nbytes
            t = _to_tensor(arr, entry["dtype"]).to(dtype=ab.dtype)
            if layout is not None:
                shape, spec = layout[key]
                if tuple(t.shape) != shape:
                    raise ValueError(f"{key}: stored {tuple(t.shape)}, the "
                                     f"layout's {shape}")
                t = specs.local_shard(t, spec, mesh.mesh, mesh.coords)
            return t.to(device=dev)
        out = _unflatten(abstract_tree, load)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.restores.append({"step": step, "bytes": nbytes,
                              "seconds": time.perf_counter() - t0})
        return out

    def restore_latest(self, abstract_tree: Any, device="cuda", *,
                       retries: int = 4, mesh=None, par=None, schema=None):
        """Restore the newest checkpoint, tolerating a concurrent writer.

        A reader whose restore spans a GC pass can lose the step it picked:
        on FileNotFound it re-lists and retries on whatever is newest then.
        An EMPTY listing can be transient too (``list`` walks directory by
        directory, racing save + GC), so ``(None, None)`` is returned only
        after the whole retry budget agrees the store is empty.  Across
        ranks rank 0 lists and every rank restores the step it picked; a
        rank that loses a GC race makes every rank retry."""
        err: Optional[BaseException] = None
        for _ in range(retries + 1):
            step = self.latest_step() if mesh is None or mesh.rank == 0 \
                else None
            if mesh is not None:
                step = mesh.from_rank0([0 if step is None else step + 1])[0]
                step = step - 1 if step else None
            if step is None:
                continue                     # possibly a racing re-list
            try:
                manifest = self.store.get_json(
                    f"{self._step_dir(step)}/MANIFEST.json")
                tree = self.restore(step, abstract_tree, device, mesh=mesh,
                                    par=par, schema=schema)
                lost = False
            except FileNotFoundError as e:   # lost a GC race; re-list
                err, lost = e, True
            if mesh is not None:
                lost = mesh.any_rank(lost)   # any rank's loss: all retry
            if not lost:
                return tree, {"step": step, **manifest.get("extra", {})}
        if err is not None:
            raise err
        return None, None
