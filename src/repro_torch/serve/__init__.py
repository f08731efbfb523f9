"""Serving engines: packets (``packet_engine``) and the LM (``engine``)."""
