"""Pose-velocity graph optimization (Levenberg-Marquardt)."""
