"""Parameters, glacier containers and device resolution."""
