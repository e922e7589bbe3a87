"""Text models."""
