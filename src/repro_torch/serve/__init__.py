"""Serving on top of fitted GPs in the port: artifact and bucketed engine."""
