"""Launchers of the port: ``serve`` (the LM serving loop)."""
