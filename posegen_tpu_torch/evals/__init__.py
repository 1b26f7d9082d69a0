"""Evaluation metrics (port of posegen_tpu/evals/)."""
