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

``saves`` and ``restores`` record each call's seconds and bytes.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device

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
        # one entry a committed save: step, snapshot_s (the host copy),
        # write_s (files, manifest and GC), bytes
        self.saves: List[Dict[str, float]] = []
        # one entry a restore: step, seconds (read + cast + place), bytes
        self.restores: List[Dict[str, float]] = []

    # ----------------------------------------------------------------- save
    def _step_dir(self, step: int) -> str:
        return f"{self.prefix}/step_{step:010d}"

    @staticmethod
    def _snapshot(tree: Any):
        t0 = time.perf_counter()
        leaves = [(key, *_host_leaf(leaf))
                  for key, leaf in flatten_with_paths(tree)]
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

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Synchronous save + atomic manifest commit + GC."""
        leaves, snapshot_s = self._snapshot(tree)
        self._write(step, leaves, extra, snapshot_s)

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        """Copy every leaf to the host now; write in the background."""
        self.wait()
        leaves, snapshot_s = self._snapshot(tree)

        def work():
            try:
                self._write(step, leaves, extra, snapshot_s)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

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

    def restore(self, step: int, abstract_tree: Any, device="cuda") -> Any:
        """Rebuild ``abstract_tree``-shaped state (leaves with a torch
        ``dtype``: tensors, or ``meta`` tensors), each leaf cast to its
        abstract leaf's dtype and placed on ``device``."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        manifest = self.store.get_json(f"{self._step_dir(step)}/MANIFEST.json")
        by_key = {entry["key"]: entry for entry in manifest["leaves"]}
        nbytes = 0

        def load(key, ab):
            nonlocal nbytes
            entry = by_key[key]
            arr = self.store.get_array(entry["shards"][0])
            nbytes += arr.nbytes
            return _to_tensor(arr, entry["dtype"]).to(device=dev,
                                                      dtype=ab.dtype)
        out = _unflatten(abstract_tree, load)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.restores.append({"step": step, "bytes": nbytes,
                              "seconds": time.perf_counter() - t0})
        return out

    def restore_latest(self, abstract_tree: Any, device="cuda", *,
                       retries: int = 4):
        """Restore the newest checkpoint, tolerating a concurrent writer.

        A reader whose restore spans a GC pass can lose the step it picked:
        on FileNotFound it re-lists and retries on whatever is newest then.
        An EMPTY listing can be transient too (``list`` walks directory by
        directory, racing save + GC), so ``(None, None)`` is returned only
        after the whole retry budget agrees the store is empty."""
        err: Optional[BaseException] = None
        for _ in range(retries + 1):
            step = self.latest_step()
            if step is None:
                continue                     # possibly a racing re-list
            try:
                manifest = self.store.get_json(
                    f"{self._step_dir(step)}/MANIFEST.json")
                return self.restore(step, abstract_tree, device), \
                    {"step": step, **manifest.get("extra", {})}
            except FileNotFoundError as e:   # lost a GC race; re-list
                err = e
        if err is not None:
            raise err
        return None, None
