"""Kernel profiles, the dense oracle and the forward distance-tile MVM."""
