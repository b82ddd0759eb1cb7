"""Plan IR, halo geometry, executor and the windowed engine."""
