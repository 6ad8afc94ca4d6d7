"""Optimisers of the port."""
