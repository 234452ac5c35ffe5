"""Ops of the port: dense attention and paged attention."""
