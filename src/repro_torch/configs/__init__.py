"""Assigned architecture configs (one module per arch) + shapes."""
