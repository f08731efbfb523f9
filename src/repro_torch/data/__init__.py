"""Seeded packet streams (numpy only)."""
