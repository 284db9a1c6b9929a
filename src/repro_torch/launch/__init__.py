"""Launchers of the port (the port of ``src/repro/launch``): serving."""
