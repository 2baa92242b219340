"""Entry points of the port."""
