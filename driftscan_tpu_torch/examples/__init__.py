"""Walkthroughs of the repository's examples on the port."""
