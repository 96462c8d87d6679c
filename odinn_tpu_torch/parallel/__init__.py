"""Scale-out (``mesh``: the registered mesh, single device only)."""
