"""Step functions and the serving command line."""
