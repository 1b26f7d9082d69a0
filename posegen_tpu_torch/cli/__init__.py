"""Command-line entry points of the port (posegen_tpu/cli/)."""
