"""Model containers and law resolution."""
