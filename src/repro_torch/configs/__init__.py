"""Model configs (dataclasses) and the ``--arch`` registry."""
