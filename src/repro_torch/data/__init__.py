"""Corpus generation and the sharded document store."""
