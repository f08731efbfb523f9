"""Seeded packet streams and datasets, and the synthetic LM token stream
(numpy only)."""

from repro_torch.data.tokens import TokenDataset
