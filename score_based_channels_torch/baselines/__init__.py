"""Baselines the paper sets against the score-based estimator: LS, exact
LMMSE, Lasso (FISTA), EM-GM-AMP and approximate MMSE by posterior
averaging."""
