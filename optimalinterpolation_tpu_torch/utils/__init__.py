"""Observability helpers: stage timers and the profiler trace."""
