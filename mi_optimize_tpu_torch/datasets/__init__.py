"""Calibration and evaluation data: wikitext2, PTB and C4 (datasets.calibration)."""
