"""Serving engines: packets (``packet_engine``) and the LM (``engine``),
and the online loop around the packet engine (``online``)."""

from repro_torch.serve.online import BackgroundRetrainer, HotSwapController
from repro_torch.serve.packet_engine import PacketServeEngine, ServeStats
