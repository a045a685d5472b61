"""Linear-MMSE baseline (the default warm start of `estimate`)."""
