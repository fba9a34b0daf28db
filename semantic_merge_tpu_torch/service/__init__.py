"""The merge service: a warm daemon and its thin client (the port of the
JAX package's ``service/``).

One-shot runs pay their worst costs before the first op is diffed:
interpreter and torch import, the kernels' load, a cold decl cache, a
fresh interner. The daemon holds all of that across requests on a unix
socket, and the client delegates merge-shaped CLI invocations to it.

- :mod:`.protocol` — wire format (newline JSON-RPC), socket-path
  resolution (the port's own default socket), request-env capture;
- :mod:`.daemon` — the server: bounded admission queue, executor
  threads, per-repo serialization of ``--inplace`` work, warm caches,
  graceful lifecycle, on one device;
- :mod:`.client` — ``SEMMERGE_DAEMON=auto|require|off`` delegation with
  spawn-if-absent;
- :mod:`.supervisor` — ``serve --supervise``;
- :mod:`.resilience` — circuit breakers and RSS watermarks;
- :mod:`.residency` — warm snapshot residency;
- :mod:`.telemetry` — ``/metrics`` and ``/healthz`` on loopback.

The contract throughout is byte parity: a request executed by the
daemon produces the same tree bytes, artifacts, exit code and notes as
the same argv run one-shot (``tests/test_torch_service.py``).
"""
