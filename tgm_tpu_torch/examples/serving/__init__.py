"""Serving examples of the port."""
