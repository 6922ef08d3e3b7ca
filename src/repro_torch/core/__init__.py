"""Host-side metrics and the lease-based work queue (stdlib only)."""
