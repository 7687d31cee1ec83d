"""Displacement-field extraction."""
