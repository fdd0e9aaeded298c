"""Sweep operators: the local update, the plain sweeps and the K1 kernel."""
