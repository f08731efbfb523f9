"""The LM stack (counterpart of ``repro.models``): layers, attention
with its KV caches (full, int8 and the rolling window) and
cross-attention, the Mamba block, the MoE layer, the xLSTM blocks, the
decoder (and encoder) forward and the parameter registry: every family
of the reference."""
