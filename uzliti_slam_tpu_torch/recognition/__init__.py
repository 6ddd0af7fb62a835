"""Place recognition."""
