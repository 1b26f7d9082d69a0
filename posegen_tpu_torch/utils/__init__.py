"""Synthetic fixtures and the weight bridge from posegen_tpu."""
