"""Models of the port: the flagship transformer and its scoring program."""
