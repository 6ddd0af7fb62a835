"""Synthetic pose-graph generation."""
