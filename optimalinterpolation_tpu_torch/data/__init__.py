"""Host-side numpy data plane (copies of the JAX package's data modules)."""
