"""Hand-written adjoints: the adjoint-method and VJP-flavor types, the VJPs
of the SIA2D right-hand side and the discrete and continuous adjoint
sweeps."""
