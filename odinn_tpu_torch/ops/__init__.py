"""Stencils and the fused kernels."""
