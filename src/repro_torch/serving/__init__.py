"""Live serving engine and its paged model paths."""
