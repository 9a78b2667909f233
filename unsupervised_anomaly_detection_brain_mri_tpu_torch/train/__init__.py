"""Trainers of the port (inference half so far)."""
