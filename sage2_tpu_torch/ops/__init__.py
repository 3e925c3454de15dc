"""Key arithmetic and segment utilities."""
