"""Applications built on the port's workflow engine (the CONNECT case study)."""
