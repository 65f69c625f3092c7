"""Batched pinhole cameras and similarity transforms."""
