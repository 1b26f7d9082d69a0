"""The NeRF field and its compositor."""
