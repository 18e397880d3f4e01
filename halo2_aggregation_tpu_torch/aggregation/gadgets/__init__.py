"""Arithmetic gadgets for the aggregation circuit."""
