"""The LM stack (counterpart of ``repro.models``): layers, attention
with its KV caches, the Mamba block, the MoE layer, the decoder forward
and the parameter registry.  The dense and hybrid families, so far
(ROADMAP Queue 1 item 6)."""
