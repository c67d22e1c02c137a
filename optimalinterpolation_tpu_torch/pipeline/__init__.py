"""Daily field production."""
