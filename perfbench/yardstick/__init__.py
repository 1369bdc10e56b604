"""Frozen yardsticks: the kernels' work formulas, the card's peaks and the
seeded inputs."""
