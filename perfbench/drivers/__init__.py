"""One driver per entry point of the port; each cell names its driver."""
