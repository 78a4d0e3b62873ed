"""Serving stack of the port: the continuous-batching
:class:`ServingEngine` (slot and paged layouts; chunked or monolithic
prefill, the pipelined loop, multi-step decode, speculative decoding,
the host-RAM KV tier, live weight swaps, KV export/import, the loop
thread) with its scheduler, block pools and radix prefix index; the TCP
front end (:class:`LMServer` / :class:`ServingClient`, the reference's
wire); and the weight codec and feeders (:mod:`weights`). The router and
fleet controller are not ported yet (ROADMAP A11b)."""

from distkeras_torch.serving.engine import ServingEngine  # noqa: F401
from distkeras_torch.serving.kvpool import (  # noqa: F401
    BlockPool,
    HostBlockPool,
    OutOfBlocksError,
)
from distkeras_torch.serving.prefix import PrefixMatch, RadixPrefixIndex  # noqa: F401
from distkeras_torch.serving.scheduler import (  # noqa: F401
    DEFAULT_PREFILL_CHUNK,
    QOS_TIERS,
    DrainingError,
    FIFOScheduler,
    QueueFullError,
    Request,
    TokenStream,
)
from distkeras_torch.networking import FrameError  # noqa: F401
from distkeras_torch.serving.server import (  # noqa: F401
    DISCONNECTED,
    LMServer,
    OverloadedError,
    ServingClient,
    ServingConnectionError,
    UnknownOpError,
)
from distkeras_torch.serving.weights import (  # noqa: F401
    CheckpointWatcher,
    ParameterServerFeed,
    WeightPushError,
    deserialize_weights,
    serialize_weights,
    validate_like,
)

__all__ = [
    "ServingEngine",
    "DEFAULT_PREFILL_CHUNK",
    "BlockPool",
    "HostBlockPool",
    "OutOfBlocksError",
    "PrefixMatch",
    "RadixPrefixIndex",
    "FIFOScheduler",
    "QueueFullError",
    "DrainingError",
    "OverloadedError",
    "ServingConnectionError",
    "UnknownOpError",
    "FrameError",
    "DISCONNECTED",
    "Request",
    "TokenStream",
    "LMServer",
    "ServingClient",
    "WeightPushError",
    "serialize_weights",
    "deserialize_weights",
    "validate_like",
    "CheckpointWatcher",
    "ParameterServerFeed",
    "QOS_TIERS",
]
