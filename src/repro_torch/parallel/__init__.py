"""Sharding rules of the port (``repro/parallel`` counterpart)."""
