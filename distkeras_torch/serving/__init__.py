"""Serving stack of the port: the continuous-batching
:class:`ServingEngine` (slot and paged layouts, chunked prefill) with
its scheduler, block pool and radix prefix index. The TCP front end,
router and fleet controller are not ported yet (ROADMAP A11)."""

from distkeras_torch.serving.engine import ServingEngine  # noqa: F401
from distkeras_torch.serving.kvpool import BlockPool, OutOfBlocksError  # noqa: F401
from distkeras_torch.serving.prefix import PrefixMatch, RadixPrefixIndex  # noqa: F401
from distkeras_torch.serving.scheduler import (  # noqa: F401
    QOS_TIERS,
    DrainingError,
    FIFOScheduler,
    QueueFullError,
    Request,
    TokenStream,
)

__all__ = [
    "ServingEngine",
    "BlockPool",
    "OutOfBlocksError",
    "RadixPrefixIndex",
    "PrefixMatch",
    "FIFOScheduler",
    "Request",
    "TokenStream",
    "QueueFullError",
    "DrainingError",
    "QOS_TIERS",
]
