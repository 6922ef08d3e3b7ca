"""ObjectStore — the Ceph/Rook analogue (paper §II-A).

CHASE-CI mounts a distributed Ceph object store visible to every pod; the
workflow moves data through it between steps.  This is the same interface
backed by a local directory with ATOMIC writes (tmp + rename), so a real
deployment swaps in a Ceph/S3 client without touching callers.  Arrays go
through ``put_array``/``get_array`` (npy bytes); manifests are JSON.

A copy of the JAX package's ``data/objectstore.py`` (it needs only numpy),
so the port's checkpoints are the same files, byte for byte.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import List

import numpy as np


class BlobCodecs:
    """Typed serialization over the raw blob API (``put``/``get``/``list``/
    ``size``), so callers never care which store they hold."""

    def put_array(self, key: str, arr: np.ndarray) -> int:
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr), allow_pickle=False)
        data = buf.getvalue()
        self.put(key, data)
        return len(data)

    def get_array(self, key: str) -> np.ndarray:
        return np.load(io.BytesIO(self.get(key)), allow_pickle=False)

    def put_json(self, key: str, obj) -> None:
        self.put(key, json.dumps(obj, indent=1, default=str).encode())

    def get_json(self, key: str):
        return json.loads(self.get(key))

    def total_bytes(self, prefix: str = "") -> int:
        return sum(self.size(k) for k in self.list(prefix))


class ObjectStore(BlobCodecs):
    def __init__(self, root: str):
        # resolve once so _path containment and list's relative_to agree
        # even when `root` itself is relative or reached via a symlink
        self.root = Path(root).resolve()
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        # Path.relative_to is the component-wise containment check: a plain
        # string startswith() admitted sibling dirs with a common prefix
        # (root /x/store accepted /x/store2/...).
        try:
            p.relative_to(self.root)
        except ValueError:
            raise ValueError(f"key escapes store: {key}") from None
        return p

    # ------------------------------------------------------------------ api
    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)          # atomic commit
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def delete(self, key: str) -> bool:
        p = self._path(key)
        if p.is_file():
            p.unlink()
            return True
        return False

    def list(self, prefix: str = "") -> List[str]:
        """Keys under ``prefix``, path-aware: the prefix names an exact key
        or a key-path subtree — ``"ab"`` matches ``ab`` and ``ab/x`` but
        never ``abc/...``.  Only the prefix subtree is walked, so listing
        one workflow's keys is O(that subtree), not O(total objects)."""
        if not prefix:
            base = self.root
        else:
            base = self._path(prefix.rstrip("/"))
            if base.is_file():
                return [] if prefix.endswith("/") \
                    else [str(base.relative_to(self.root))]
        if not base.is_dir():
            return []
        out = [str(p.relative_to(self.root)) for p in base.rglob("*")
               if p.is_file() and not p.name.startswith(".tmp-")]
        return sorted(out)

    def size(self, key: str) -> int:
        return self._path(key).stat().st_size
