"""Statistics and profiling (``utils.stats``)."""
