"""Logical-axis -> mesh-axis rules and per-device shard shapes."""
