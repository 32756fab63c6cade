"""Bebop wire types, record pages and device decode planning."""
