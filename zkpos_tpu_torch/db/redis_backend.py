"""Minimal Redis client (RESP2 over a socket) + the task-queue backend;
counterpart of zkpos_tpu/db/redis_backend.py (byte-identical requests).

The reference distributes proving work through the Redis list
`por_batch_task_queue_<suffix>` with LPUSH (dbtool main.go:217) and BRPOP
(prover.go:74), and dbtool's -delete_all issues FLUSHALL.  This module speaks
the wire protocol directly, with no client package — the
subset the reference uses: LPUSH / BRPOP / RPOP / LLEN / DEL / FLUSHALL /
PING / AUTH.  RESP2 framing per the public protocol spec: requests as
arrays of bulk strings, replies as +simple/-error/:int/$bulk/*array.

`RedisTaskQueue` presents the same surface as db.queue.TaskQueue so the
prover/dbtool services select it purely by config (redis address present ->
real Redis; otherwise the sqlite-backed queue with identical semantics).
"""

from __future__ import annotations

import socket
from typing import List, Optional


class RedisError(Exception):
    pass


class RedisClient:
    """RESP2 client over one blocking socket (thread-unsafe; one per
    worker, like the reference's per-prover connection)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: str = "", timeout: float = 30.0):
        self.host, self.port = host, port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._password = password

    def _conn(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            if self._password:
                self.command("AUTH", self._password)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    # -- wire framing ---------------------------------------------------------

    @staticmethod
    def _encode(args) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, int):
                a = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._conn().recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._conn().recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply()
                                         for _ in range(n)]
        raise RedisError(f"bad reply type {line!r}")

    def command(self, *args, timeout: Optional[float] = None):
        s = self._conn()
        if timeout is not None:
            s.settimeout(timeout)
        try:
            s.sendall(self._encode(args))
            return self._read_reply()
        except (OSError, RedisError):
            self.close()
            raise
        finally:
            if timeout is not None and self._sock is not None:
                self._sock.settimeout(self.timeout)

    # -- commands the reference uses ------------------------------------------

    def ping(self) -> bool:
        return self.command("PING") == "PONG"

    def lpush(self, key: str, *values) -> int:
        return self.command("LPUSH", key, *values)

    def rpop(self, key: str) -> Optional[bytes]:
        return self.command("RPOP", key)

    def brpop(self, key: str, timeout: float) -> Optional[bytes]:
        # redis BRPOP returns [key, value] or nil on timeout
        reply = self.command("BRPOP", key, int(timeout),
                             timeout=timeout + self.timeout)
        return None if reply is None else reply[1]

    def llen(self, key: str) -> int:
        return self.command("LLEN", key)

    def delete(self, key: str) -> int:
        return self.command("DEL", key)

    def flushall(self) -> None:
        self.command("FLUSHALL")


class RedisTaskQueue:
    """db.queue.TaskQueue surface over a real Redis list — the exact
    protocol of the reference fleet (list `por_batch_task_queue_<suffix>`,
    LPUSH producer, BRPOP consumers)."""

    def __init__(self, client: RedisClient, suffix: str = ""):
        self.client = client
        self.key = f"por_batch_task_queue_{suffix}"

    def lpush(self, *values) -> None:
        self.client.lpush(self.key, *[str(v) for v in values])

    def rpop(self) -> Optional[str]:
        v = self.client.rpop(self.key)
        return None if v is None else v.decode()

    def brpop(self, timeout: float = 10.0) -> Optional[str]:
        v = self.client.brpop(self.key, timeout)
        return None if v is None else v.decode()

    def flush(self) -> None:
        self.client.delete(self.key)

    def llen(self) -> int:
        return self.client.llen(self.key)


def queue_from_config(cfg, db) -> object:
    """Select the queue backend the way the reference config does: a
    redis address (config.Redis.Host, src/prover/config/config.go:5-8)
    means the real list; otherwise the sqlite queue keeps identical
    semantics for single-host runs and CI."""
    addr = getattr(cfg, "redis_addr", "") or ""
    if addr:
        host, _, port = addr.partition(":")
        client = RedisClient(host or "127.0.0.1", int(port or 6379),
                             password=getattr(cfg, "redis_password", ""))
        return RedisTaskQueue(client, getattr(cfg, "db_suffix", ""))
    from .queue import TaskQueue
    return TaskQueue(db, getattr(cfg, "db_suffix", ""))
