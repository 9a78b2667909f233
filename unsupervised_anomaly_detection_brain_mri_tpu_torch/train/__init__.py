"""Trainers of the port (``train/registry.py`` lists them)."""
