"""Exact-GP models of the port."""
