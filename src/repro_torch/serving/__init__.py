"""Continuous-batching serving: scheduler and block pool (host policy),
engine (device side), report (gauge names, Table-I row), and the router
(replicas behind a session-affine router, an autoscaler).  The router's
entry points are exported here; import the other submodules directly."""
from repro_torch.serving.router import (Autoscaler, Replica, ReplicaSet,
                                        serve_replicated)

__all__ = ["Autoscaler", "Replica", "ReplicaSet", "serve_replicated"]
