"""Utilities of the port: planted-structure models (planted.py)."""
