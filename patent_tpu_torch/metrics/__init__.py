"""Retrieval metrics of the reference protocol."""
