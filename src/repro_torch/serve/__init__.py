"""Serving engines: packets (``packet_engine``, sharded across devices in
``sharded``) and the LM (``engine``), and the online loop around the
packet engine (``online``)."""

from repro_torch.serve.online import BackgroundRetrainer, HotSwapController
from repro_torch.serve.packet_engine import PacketServeEngine, ServeStats
from repro_torch.serve.sharded import (
    ShardedFlowState,
    ShardedPacketServeEngine,
)
