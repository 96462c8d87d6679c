"""Empirical loss functions."""
