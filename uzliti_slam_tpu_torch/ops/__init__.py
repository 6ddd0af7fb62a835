"""SE(3) Lie-group operations."""
