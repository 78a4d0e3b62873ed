"""Serving stack of the port: the continuous-batching
:class:`ServingEngine` (slot and paged layouts; chunked or monolithic
prefill, the pipelined loop, multi-step decode, speculative decoding,
the host-RAM KV tier, live weight swaps, KV export/import) with its
scheduler, block pools and radix prefix index. The TCP front end,
router and fleet controller are not ported yet (ROADMAP A11)."""

from distkeras_torch.serving.engine import ServingEngine  # noqa: F401
from distkeras_torch.serving.kvpool import (  # noqa: F401
    BlockPool,
    HostBlockPool,
    OutOfBlocksError,
)
from distkeras_torch.serving.prefix import PrefixMatch, RadixPrefixIndex  # noqa: F401
from distkeras_torch.serving.scheduler import (  # noqa: F401
    QOS_TIERS,
    DrainingError,
    FIFOScheduler,
    QueueFullError,
    Request,
    TokenStream,
)
from distkeras_torch.serving.weights import WeightPushError  # noqa: F401

__all__ = [
    "ServingEngine",
    "BlockPool",
    "HostBlockPool",
    "OutOfBlocksError",
    "WeightPushError",
    "RadixPrefixIndex",
    "PrefixMatch",
    "FIFOScheduler",
    "Request",
    "TokenStream",
    "QueueFullError",
    "DrainingError",
    "QOS_TIERS",
]
