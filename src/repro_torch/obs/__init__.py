"""Serving metrics."""
