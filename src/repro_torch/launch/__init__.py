"""Launchers of the port: the multi-process runtime (launch/runtime)."""
