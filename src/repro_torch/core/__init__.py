"""Typed errors shared by the port (a copy of the reference's hierarchy)."""
