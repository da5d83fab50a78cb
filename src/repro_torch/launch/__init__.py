"""Serving and (later) training launchers of the port."""
