"""Circuits: the simple-example inner circuit and the aggregation circuit."""
