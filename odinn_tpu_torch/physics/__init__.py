"""SIA2D physics: targets, right-hand side, mass balance."""
