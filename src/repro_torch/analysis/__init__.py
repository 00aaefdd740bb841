"""Cost analysis of the port's steps."""
