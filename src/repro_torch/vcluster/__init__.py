"""The near-real-time monitor bus (``monitor``).  The tenant slices and
the fair-share scheduler of the JAX package's ``vcluster`` are not
ported yet."""
from repro_torch.vcluster.monitor import Event, EventBus, Subscription

__all__ = ["Event", "EventBus", "Subscription"]
