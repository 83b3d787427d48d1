"""Example applications of the port."""
