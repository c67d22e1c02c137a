"""Cell sharding over several devices: ``parallel.mesh``."""
