"""Trainers of the port (the ``AE`` trainer so far)."""
