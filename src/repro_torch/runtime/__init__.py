"""Prefill / decode step functions and the KV cache layouts."""
