"""Ingest, search and serving over the port's encoder and index."""
