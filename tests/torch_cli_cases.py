"""The command-line tools run on a cluster of each package.

``Site`` boots ``tests/torch_cluster_cases.py``'s cluster (a monitor, N
OSDs, librados) of one package on an event loop of its own, optionally
with the CephFS pools and an active MDS.  ``Site.cli`` runs a tool's
``main`` in a thread while the cluster's loop keeps turning, as
``tests/test_client.py::test_cli_smoke`` does, and returns its exit code
and what it printed; ``Site.spawn`` starts a tool that serves until a
signal (``rgw_cli serve``, ``rbd_mirror``, ``cephfs_mirror``) as a process
of its own.  The port's tools get ``--device cpu``.  ``mask`` takes out
what follows the clock or a random draw (times, rates, ids, ports), so the
two packages' outputs can be compared as text.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import io
import os
import re
import sys
import threading

from torch_cluster_cases import PORT, REF, Cluster, Side, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60


def mask(text: str) -> str:
    text = re.sub(r"127\.0\.0\.1:\d+", "ADDR", text)
    text = re.sub(r"\d+\.\d+(e[-+]\d+)?", "T", text)
    text = re.sub(r"\b[0-9a-f]{10,}\b", "ID", text)
    return re.sub(r"bytes/sec \d+", "bytes/sec N", text)


class Site:
    """One package's cluster on an event loop: a loop of its own, or
    ``loop``, another site's (two sites of one loop both turn while either
    runs)."""

    def __init__(self, pkg: str, n_osds: int = 3, fs: bool = False,
                 loop=None) -> None:
        self.side = Side(pkg)
        self.own_loop = loop is None
        self.loop = loop or asyncio.new_event_loop()
        self.mds = None
        self.c = self.run(Cluster.boot(self.side, n_osds))
        self.addr = self.c.mon.msgr.addr
        self.mon = f"{self.addr[0]}:{self.addr[1]}"
        if fs:
            self.run(self._start_fs())

    def run(self, coro):
        return self.loop.run_until_complete(asyncio.wait_for(coro, TIMEOUT))

    def mod(self, name: str):
        return importlib.import_module(f"{self.side.pkg}.{name}")

    async def _start_fs(self) -> None:
        for p in ("cephfs_metadata", "cephfs_data"):
            await self.c.rados.pool_create(p, pg_num=4)
        self.mds = self.mod("mds").MDS(name="a", **self.side.dev)
        await self.mds.start(self.addr, create_pools=False)
        await wait_for(lambda: self.mds.state == "active", 30,
                       "the MDS active")

    async def mount(self):
        return await self.mod("mds").CephFS(self.addr, **self.side.dev
                                            ).mount()

    def device_args(self, tool: str) -> list[str]:
        return ["--device", "cpu"] if self.side.is_port \
            and tool != "exporter" else []

    def cli(self, tool: str, *argv: str) -> tuple[int, str]:
        """``tool``'s ``main`` on ``argv`` in a thread, the cluster's loop
        turning meanwhile: (exit code, standard output)."""
        main = self.mod(f"tools.{tool}").main
        argv = [*self.device_args(tool), *argv]
        result: dict = {}

        def target():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result["rc"] = main(argv)
            result["out"] = buf.getvalue()
        t = threading.Thread(target=target)
        t.start()
        while t.is_alive():
            self.loop.run_until_complete(asyncio.sleep(0.02))
        t.join()
        return result["rc"], result["out"]

    async def spawn(self, tool: str, *argv: str):
        """``python -m <pkg>.tools.<tool>`` as a process of its own; its
        standard output piped."""
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
        return await asyncio.create_subprocess_exec(
            sys.executable, "-m", f"{self.side.pkg}.tools.{tool}",
            *self.device_args(tool), *argv, cwd=REPO, env=env,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)

    @staticmethod
    async def banner(proc) -> str:
        return (await asyncio.wait_for(proc.stdout.readline(),
                                       TIMEOUT)).decode()

    @staticmethod
    async def end(proc) -> tuple[int, str]:
        """SIGTERM; (exit code, the rest of its output)."""
        proc.terminate()
        out, _ = await asyncio.wait_for(proc.communicate(), TIMEOUT)
        return proc.returncode, out.decode()

    def stop(self) -> None:
        async def fin():
            if self.mds is not None:
                await self.mds.stop()
            await self.c.stop()
        try:
            self.run(fin())
        finally:
            if self.own_loop:
                self.loop.close()


def on_both(script, *args, **kw) -> tuple:
    """``script(pkg, *args, **kw)`` for the reference, then the port."""
    return script(REF, *args, **kw), script(PORT, *args, **kw)
