"""Utilities: per-device op accounting of a traced step."""
