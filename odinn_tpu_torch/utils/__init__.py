"""Utilities (``flatten``: θ tree ↔ flat vector)."""
