"""Measurement tools of the port (ports of the repo's tools/)."""
