"""Datasets and their builders (port of posegen_tpu/data/)."""
