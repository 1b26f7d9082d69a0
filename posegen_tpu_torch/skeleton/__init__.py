"""Skeleton tables, rotations, forward kinematics and bounding geometry."""
