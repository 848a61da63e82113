"""Prometheus exposition: shared renderer + the mgr module.

The mgr module serves GET /metrics the way the reference's
src/pybind/mgr/prometheus module does (cluster state from the maps +
per-daemon perf counters from the DaemonServer reports); the same
renderer backs the standalone exporter (src/exporter analog,
tools/exporter.py) which scrapes admin sockets instead.

Port of ``ceph_tpu/mgr/prometheus.py``, copied: host code only.
"""

from __future__ import annotations

import asyncio


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def render_metrics(families: dict[str, dict]) -> str:
    """{metric: {"help": str, "type": str,
                 "samples": [(labels_dict, value)]}} -> text format."""
    out: list[str] = []
    for name in sorted(families):
        fam = families[name]
        out.append(f"# HELP {name} {fam.get('help', '')}")
        out.append(f"# TYPE {name} {fam.get('type', 'gauge')}")
        for labels, value in fam["samples"]:
            if labels:
                lbl = ",".join(f'{k}="{_esc(v)}"'
                               for k, v in sorted(labels.items()))
                out.append(f"{name}{{{lbl}}} {value}")
            else:
                out.append(f"{name} {value}")
    return "\n".join(out) + "\n"


def families_from_perf(daemon: str, counters: dict,
                       prefix: str = "ceph") -> dict:
    """Flatten a perf-counter summary into labeled samples."""
    fams: dict[str, dict] = {}
    for key, val in counters.items():
        if isinstance(val, dict):
            val = val.get("value")     # non-counter dicts are skipped,
        if not isinstance(val, (int, float)) \
                or isinstance(val, bool):   # not coerced to a bogus 0
            continue
        name = f"{prefix}_{key}"
        fams.setdefault(name, {"help": f"perf counter {key}",
                               "type": "counter", "samples": []})
        fams[name]["samples"].append(({"ceph_daemon": daemon}, val))
    return fams


def merge_families(*many: dict) -> dict:
    out: dict[str, dict] = {}
    for fams in many:
        for name, fam in fams.items():
            if name in out:
                out[name]["samples"].extend(fam["samples"])
            else:
                out[name] = {"help": fam.get("help", ""),
                             "type": fam.get("type", "gauge"),
                             "samples": list(fam["samples"])}
    return out


class MetricsHttpServer:
    """Tiny hardened GET-only HTTP server (overall request deadline,
    header-count cap).  ``render`` is either the legacy /metrics
    coroutine or, with ``router=True``, a ``(path) -> (status,
    content_type, bytes)`` coroutine -- the dashboard rides the same
    hardened loop instead of hand-rolling a second one."""

    def __init__(self, render, router: bool = False) -> None:
        self._render = render
        self._router = router
        self._server: asyncio.AbstractServer | None = None
        self.addr: tuple[str, int] | None = None

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._conn, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _conn(self, reader, writer) -> None:
        try:
            # one overall deadline for the whole request: a per-line
            # timeout lets a byte-dripping client hold the task forever
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 15.0
            line = await asyncio.wait_for(
                reader.readline(), deadline - loop.time())
            for _ in range(200):           # header-count cap
                remaining = deadline - loop.time()
                if remaining <= 0:         # HARD deadline: a dripper
                    return                 # cannot stretch it per-line
                h = await asyncio.wait_for(reader.readline(), remaining)
                if h in (b"\r\n", b"\n", b""):
                    break
            path = line.split()[1].decode() if len(line.split()) > 1 \
                else "/"
            if self._router:
                status, ctype, body = await self._render(
                    path.split("?")[0])
            elif path.rstrip("/") in ("", "/metrics".rstrip("/")):
                body = (await self._render()).encode()
                status = "200 OK"
                ctype = "text/plain; version=0.0.4"
            else:
                body = b"try /metrics\n"
                status = "404 Not Found"
                ctype = "text/plain"
            writer.write((f"HTTP/1.1 {status}\r\n"
                          f"content-type: {ctype}\r\n"
                          f"content-length: {len(body)}\r\n"
                          f"connection: close\r\n\r\n").encode())
            writer.write(body)
            await writer.drain()
        except (ConnectionError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, IndexError, ValueError):
            # ValueError covers LimitOverrunError (oversized lines)
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
