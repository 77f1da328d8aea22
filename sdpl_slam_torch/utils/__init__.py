"""Config, timing, and metric utilities."""
