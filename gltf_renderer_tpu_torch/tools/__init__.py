"""Kernel study tools of the port (counterparts of tools/bench_*.py)."""
