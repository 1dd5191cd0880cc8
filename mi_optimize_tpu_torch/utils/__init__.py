"""Utilities of the port: planted-structure models (planted.py) and run
manifests, config hashes and traces (observability.py)."""
from .observability import RunManifest, config_hash, trace  # noqa: F401
