"""Data-file loaders."""
