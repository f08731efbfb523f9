"""The LM stack (counterpart of ``repro.models``): layers, attention
with its KV caches, the decoder forward and the parameter registry.
The dense family only, so far (ROADMAP Queue 1 item 6)."""
