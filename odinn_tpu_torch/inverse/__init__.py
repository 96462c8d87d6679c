"""Hand-written adjoints: the adjoint-method and VJP-flavor types, the VJPs
of the SIA2D right-hand side and the discrete and continuous adjoint
sweeps; the matrix-free Gauss–Newton / Levenberg–Marquardt trainer
(``gauss_newton``: ``make_residual_fn``, ``lm_train``); and the Laplace
posterior (``uncertainty``: ``laplace_posterior``, ``laplace_uncertainty``)."""
