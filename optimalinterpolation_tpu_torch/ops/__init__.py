"""Kernels and linear algebra of the port; K1 and K2 wrappers."""
