"""Fleet replica entry point: one bridge server, one OS process.

The port's copy of ``tensorframes_tpu/bridge/replica.py``.

``python -m tensorframes_tpu_torch.bridge.replica --host H --port P
--name N [--device D]`` serves a
:class:`~tensorframes_tpu_torch.bridge.server.BridgeServer` on (H, P)
until SIGTERM, which triggers the graceful drain (reject new admissions,
finish in-flight requests, cooperatively cancel stragglers) and exits 0
— the "drain" half of a rolling restart.  SIGKILL (the ``replica_kill``
fault, or an impatient operator) skips all of that, which is the point:
the fleet's journal-backed migration is what makes that death
survivable.

``--device`` is where the server builds and runs every program; without
it the replica serves on the CUDA card and, with no card, exits non-zero
with :func:`~tensorframes_tpu_torch.device.resolve_device`'s message
(it never falls back to the CPU).  Before it binds its port the replica
runs the program analysis's tracer once (:func:`warm_interpreter`), so
the first request after a (re)start does not pay that import.

Everything else — shared compile cache, journal dir, fleet registry,
fault specs — arrives via the environment the spawner
(:class:`~tensorframes_tpu_torch.bridge.fleet.BridgeFleet`) builds, so
this module stays a thin arg-parse around :func:`serve`.
"""

from __future__ import annotations

import argparse
import errno
import logging
import os
import signal
import socket
import sys
import threading
import time

# how long a replica restarted on its own port waits for the port to be
# released by whatever still holds it
PORT_WAIT_S = 10.0


def warm_interpreter() -> None:
    """Trace a trivial function with ``make_fx``: the first trace in an
    interpreter imports the tracing stack (``torch._dynamo``, sympy and
    their dependencies; about 8 s where no bytecode is cached), and a
    replica pays that before it reports healthy."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    make_fx(lambda x: x + 1)(torch.zeros(1))


def wait_for_port(host: str, port: int, log) -> None:
    """Return once ``host:port`` can be bound, or after ``PORT_WAIT_S``
    (then ``serve`` raises).  A replica restarted on its own port may find
    it briefly held: a client's connect to the dead replica can be given
    that port as its own."""
    if not port:
        return
    deadline = time.monotonic() + PORT_WAIT_S
    while True:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((host, port))
                return
            except OSError as exc:
                if exc.errno != errno.EADDRINUSE or time.monotonic() > deadline:
                    return
        log.warning("port %s:%d is in use; waiting for it", host, port)
        time.sleep(0.2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tensorframes_tpu_torch.bridge.replica",
        description="run one bridge fleet replica (SIGTERM = drain)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--name", default="")
    p.add_argument(
        "--device", default=None,
        help="device every program runs on (default: the CUDA card)",
    )
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("tensorframes_tpu_torch.bridge.replica")

    if args.name:
        # the server reads its replica name from the env; pin it here
        # too so a hand-launched replica (no fleet spawner) still gets
        # a stable identity from --name
        from ..envutil import env_set_default
        from .fleet import ENV_FLEET_REPLICA

        env_set_default(ENV_FLEET_REPLICA, args.name)

    from ..device import resolve_device
    from .server import serve

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        # no card and no --device: say why on stderr (the spawner's log)
        # and exit non-zero
        log.error("replica %s: %s", args.name or "?", exc)
        return 1
    warm_interpreter()
    wait_for_port(args.host, args.port, log)
    server = serve(
        host=args.host, port=args.port, background=True, device=device
    )
    log.info(
        "replica %s pid=%d serving on %s:%d (device %s)",
        args.name or "?",
        os.getpid(),
        server.address[0],
        server.address[1],
        server.device,
    )

    done = threading.Event()

    def _on_term(signum, frame):  # noqa: ARG001 — signal signature
        log.info("replica %s: SIGTERM — draining", args.name or "?")
        # drain off the signal handler's thread: close() blocks on
        # in-flight requests, and a handler must return promptly
        threading.Thread(
            target=lambda: (server.close(), done.set()), daemon=True
        ).start()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    done.wait()
    log.info("replica %s: drained, exiting", args.name or "?")
    return 0


if __name__ == "__main__":
    sys.exit(main())
