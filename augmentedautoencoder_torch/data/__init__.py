"""Data pipeline: cached synthetic views + on-device domain randomization."""
