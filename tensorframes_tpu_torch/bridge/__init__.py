"""External-process front-end bridge (the L2 interop layer) on the port.

The port's copy of ``tensorframes_tpu/bridge/``: the same wire protocol
(``protocol.py``, version 2), server, client and serving layer, so a
client of either package drives a server of the other.

* ``serve`` / ``BridgeServer`` — localhost TCP server executing the verb
  protocol against in-process TensorFrames on ``device`` (None = the CUDA
  card): frames live server-side in a registry; only programs (GraphDef
  bytes), schemas and requested results cross the wire.
* ``BridgeClient`` / ``RemoteFrame`` — the reference-shaped client:
  ``create_frame``, ``analyze``, builder-style verb calls taking GraphDef
  bytes, ``collect``, ``warm``, ``run_pipeline``, ``decode``.
* Serving resilience: per-request deadlines cancelled at block and step
  boundaries, bounded admission with ``ServerBusy`` shedding,
  token-addressed sessions with idempotent retry after dropped replies,
  graceful drain, and the ungated ``health``/``metrics``/``attribution``
  RPCs.
* Serving throughput (``coalescer.py``): request coalescing over a warm
  program pool, SLO-aware fair-share admission, continuous batching, and
  paged continuous decode (``DecodeScheduler``) behind the ``decode`` RPC.

* The fleet (``fleet.py``, ``replica.py``): ``BridgeFleet`` runs N
  replicas (processes or threads) on one device with shared journal and
  compile cache, ``FleetRouter`` rendezvous-routes session keys over the
  healthy ones, and ``FleetClient`` fails over on ``Draining``, dead
  connections and ``SessionLost``.
"""

from .client import (
    BridgeClient,
    BridgeError,
    Cancelled,
    DeadlineExceeded,
    Draining,
    RemoteFrame,
    ServerBusy,
    SessionLost,
    busy_backoff_s,
)
from .coalescer import (
    Coalescer,
    ContinuousBatcher,
    SloScheduler,
    WarmPool,
    WarmSpec,
)
from .fleet import BridgeFleet, FleetClient, FleetRouter
from .server import BridgeServer, serve

__all__ = [
    "BridgeClient",
    "BridgeError",
    "BridgeFleet",
    "BridgeServer",
    "Cancelled",
    "Coalescer",
    "ContinuousBatcher",
    "DeadlineExceeded",
    "Draining",
    "FleetClient",
    "FleetRouter",
    "RemoteFrame",
    "ServerBusy",
    "SessionLost",
    "SloScheduler",
    "WarmPool",
    "WarmSpec",
    "busy_backoff_s",
    "serve",
]
