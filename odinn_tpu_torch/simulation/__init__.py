"""Time integration and forward prediction."""
