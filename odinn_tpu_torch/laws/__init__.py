"""Laws and their inputs."""
