"""Utilities of the port: registry, checkpoint conversion."""
