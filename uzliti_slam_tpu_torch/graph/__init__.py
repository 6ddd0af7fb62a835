"""Pose-graph state, factors, chain preconditioner, solver and oracle."""
