"""Synthetic glaciers and climates."""
