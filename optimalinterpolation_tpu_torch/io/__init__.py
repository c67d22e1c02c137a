"""Reference-compatible file I/O."""
