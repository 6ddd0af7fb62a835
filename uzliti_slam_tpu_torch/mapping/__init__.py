"""Occupancy-grid projection."""
