"""Package entry point.

Daemon delegation happens here, before ``cli`` (and with it torch, the
backends, the engine) is imported: when ``SEMMERGE_DAEMON=auto|require``
hands a merge-shaped invocation to a warm daemon, this process only pays
for the thin client (:mod:`semantic_merge_tpu_torch.service.client`).
Any path that does not delegate (mode off, another command, an ``auto``
fallback, a rank of a several-process job) goes through the CLI unchanged.
"""
import sys


def _main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from .service import client
    code = client.delegate(argv)
    if code is not None:
        return code
    from .cli import main
    return main(argv, delegate=False)


if __name__ == "__main__":
    sys.exit(_main())
