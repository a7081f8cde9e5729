"""Models of the port: the flagship transformer and its scoring program,
and the verb models (the MLP, logistic regression and k-means)."""
