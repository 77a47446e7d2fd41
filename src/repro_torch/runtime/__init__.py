"""Serving runtime of the port: the device serving engine."""
