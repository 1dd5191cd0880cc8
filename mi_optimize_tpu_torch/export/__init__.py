"""Checkpoints of quantized models, the calibration journal and post-hoc packing."""
from .checkpoint import CalibrationJournal, export_packed, load_model, save_model  # noqa: F401
