"""Command-line tools of the port.

``parse_addr`` is ported from ``ceph_tpu/tools/__init__.py``.
"""


def parse_addr(s: str) -> tuple[str, int]:
    """'host:port' -> (host, port); bare host gets the default port."""
    host, sep, port = s.rpartition(":")
    if not sep:
        return (s or "127.0.0.1", 6789)
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        raise ValueError(f"bad monitor address {s!r}; want HOST:PORT")
