"""Sharding rules of the port (port of ``repro/parallel/``)."""
