"""Measurement scripts of the port that need no card."""
