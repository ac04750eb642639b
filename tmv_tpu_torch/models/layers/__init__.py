"""Shared conv building blocks."""
