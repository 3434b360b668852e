"""Host utilities: the profilers."""
