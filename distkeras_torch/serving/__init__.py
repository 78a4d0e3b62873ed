"""Serving stack of the port: the continuous-batching
:class:`ServingEngine` (slot and paged layouts; chunked or monolithic
prefill, the pipelined loop, multi-step decode, speculative decoding,
the host-RAM KV tier, live weight swaps, KV export/import, the loop
thread) with its scheduler, block pools and radix prefix index; the TCP
front end (:class:`LMServer` / :class:`ServingClient`, the reference's
wire); the weight codec and feeders (:mod:`weights`); and the
multi-replica fabric above the single engine: the prefix-affinity
:class:`Router` (:mod:`router`: load-aware spill, replay-based failover,
drain, disaggregated prefill -> decode KV migration, rolling weight
updates with an SLO-guarded rollback), replica health and load
management with fleet stats/metrics aggregation (:mod:`fleet`), and the
elastic :class:`Autoscaler` over its pure :class:`DecisionEngine`
(:mod:`controller`). The three fabric modules are stdlib-only copies of
the reference's."""

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
from distkeras_torch.serving.fleet import (  # noqa: F401
    Replica,
    ReplicaManager,
    merge_metric_snapshots,
)
from distkeras_torch.serving.router import Router  # noqa: F401
from distkeras_torch.serving.controller import (  # noqa: F401
    Autoscaler,
    DecisionEngine,
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
    "Replica",
    "ReplicaManager",
    "merge_metric_snapshots",
    "Router",
    "Autoscaler",
    "DecisionEngine",
    "WeightPushError",
    "serialize_weights",
    "deserialize_weights",
    "validate_like",
    "CheckpointWatcher",
    "ParameterServerFeed",
    "QOS_TIERS",
]
