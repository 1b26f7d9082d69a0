"""Pose refinement: per-frame pose parameters, their regularizers and the
NeRF / pose flip-flop schedule."""
