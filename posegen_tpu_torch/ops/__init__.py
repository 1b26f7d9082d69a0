"""Encoders, cutoff positional embedding and ray sampling."""
