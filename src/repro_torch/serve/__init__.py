"""Packet-serving engine."""
