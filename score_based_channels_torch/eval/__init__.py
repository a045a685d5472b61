"""The estimation harness (`estimate` command)."""
