"""The subset of t3fs/utils the port's codec seams need."""
