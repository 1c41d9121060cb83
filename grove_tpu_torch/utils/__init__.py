"""Host utilities: the typed JSON codec and atomic file writes."""
