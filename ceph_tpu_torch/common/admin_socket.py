"""Per-daemon admin socket: live introspection over a unix socket.

src/common/admin_socket.cc analog: a daemon binds <dir>/<name>.asok;
clients send one JSON request line {"prefix": "...", ...} and read one
JSON reply — the `ceph daemon <name> <cmd>` transport.  Built-in
commands: help, version; daemons register the rest (perf dump, status,
config show/get/set, dump_ops_in_flight, ...).
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Awaitable, Callable

Handler = Callable[[dict], Awaitable[object]]


class AdminSocket:
    def __init__(self, path: str) -> None:
        self.path = path
        self._server: asyncio.AbstractServer | None = None
        self._handlers: dict[str, tuple[str, Handler]] = {}
        self.register("help", "list supported commands", self._h_help)
        self.register("version", "framework version", self._h_version)

    def register(self, prefix: str, desc: str, handler: Handler) -> None:
        self._handlers[prefix] = (desc, handler)

    async def start(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = await asyncio.start_unix_server(
            self._on_client, path=self.path)
        return self.path

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 1.0)
            except asyncio.TimeoutError:
                pass
        if os.path.exists(self.path):
            os.unlink(self.path)

    async def _on_client(self, reader, writer) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), 10)
            req = json.loads(line or b"{}")
            prefix = req.get("prefix", "help")
            entry = self._handlers.get(prefix)
            if entry is None:
                reply = {"error": f"unknown command {prefix!r}; "
                                  f"try 'help'"}
            else:
                try:
                    reply = {"ok": True,
                             "result": await entry[1](req)}
                except Exception as e:
                    reply = {"error": str(e)}
            writer.write(json.dumps(reply, default=str).encode() + b"\n")
            await writer.drain()
        except (asyncio.TimeoutError, json.JSONDecodeError,
                ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _h_help(self, req: dict) -> dict:
        return {p: desc for p, (desc, _) in sorted(self._handlers.items())}

    async def _h_version(self, req: dict) -> dict:
        return {"name": "ceph-tpu", "version": "0.1"}


async def admin_command(path: str, prefix: str, **kwargs) -> object:
    """Client side (`ceph daemon` analog): one command, one reply."""
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        req = {"prefix": prefix, **kwargs}
        writer.write(json.dumps(req).encode() + b"\n")
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), 10)
        if not line:
            raise RuntimeError(
                f"daemon at {path} closed connection without replying")
        reply = json.loads(line)
    finally:
        writer.close()
    if "error" in reply:
        raise RuntimeError(reply["error"])
    return reply["result"]
