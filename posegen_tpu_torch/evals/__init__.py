"""Evaluation metrics (port of posegen_tpu/evals/): image metrics, pose
metrics, and the SPIN evaluation harness (`evals/harness.py`)."""
