"""Client library + interactive terminal.

``ClientConnection`` is the README-documented public API of the reference
(README.md:8-23, ClientConnection.scala): construct with a list of
``host:port`` server addresses, a random one is chosen, and
``insert_new_vector`` fire-and-forgets a batch.  ``subscribe_outputs``
registers this client as the output sink (the LoadGenerator's role,
conf/app_server_template.conf:8).

``InteractiveClient`` reproduces the terminal loop of ``Client``
(Client.scala:61-94): ``start`` triggers a bulk load of a key range, ``test``
round-trips a ping through the server, ``quit`` exits.
"""

from __future__ import annotations

import json
import random
import socket
import threading
from typing import Callable, Dict, List, Sequence, Tuple

from ..vector.sparse import SparseVector
from .rpc import vectors_to_wire

__all__ = ["ClientConnection", "InteractiveClient"]


class ClientConnection:
    def __init__(
        self,
        remote_addresses: List[str],
        timeout: float | None = None,
        ca_file: str | None = None,
        auth_token: str | None = None,
    ):
        """``timeout`` applies to request/response calls; None blocks — the
        server may legitimately take minutes on first-compile of a new index
        shape, so finite timeouts are opt-in.  ``ca_file`` enables TLS
        (verifying the server cert against it); ``auth_token`` performs the
        shared-secret handshake before any other op."""
        if not remote_addresses:
            raise ValueError("need at least one host:port")
        # random remote selection — ClientConnection.scala:24-25
        host, port = random.choice(remote_addresses).rsplit(":", 1)
        self.address = (host, int(port))
        self._ca_file = ca_file
        self._auth_token = auth_token
        self._sock = self._connect(timeout)
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self._lock = threading.Lock()
        self._sub_thread: threading.Thread | None = None
        if auth_token is not None:
            rsp = self._request({"op": "auth", "token": auth_token})
            if not rsp.get("ok"):
                raise PermissionError(rsp.get("error", "auth failed"))

    def _connect(self, timeout: float | None):
        sock = socket.create_connection(self.address, timeout=timeout)
        if self._ca_file:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.load_verify_locations(self._ca_file)
            ctx.check_hostname = False  # self-signed deploys pin by CA file
            sock = ctx.wrap_socket(sock)
        return sock

    def _send(self, obj: dict) -> None:
        with self._lock:
            self._sock.sendall((json.dumps(obj) + "\n").encode())

    def _request(self, obj: dict) -> dict:
        # the lock must span send AND readline: two threads sharing this
        # connection would otherwise consume each other's replies (the
        # protocol has no request ids — replies match by ordering)
        with self._lock:
            self._sock.sendall((json.dumps(obj) + "\n").encode())
            line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed connection")
        return json.loads(line)

    # ------------------------------------------------------------ public API
    def insert_new_vector(
        self, vectors: Sequence[Tuple[str, SparseVector]]
    ) -> None:
        """Fire-and-forget insert (ClientConnection.scala:31-33)."""
        self._send({"op": "insert", "vectors": vectors_to_wire(vectors)})

    def load_data(self, table: str, start_row: int, end_row: int) -> None:
        self._send(
            {"op": "load", "table": table, "start": start_row, "end": end_row}
        )

    def test(self, content: str) -> dict:
        return self._request({"op": "test", "content": content})

    def all_pairs(self, tau: float | None = None) -> List[Tuple[str, str, float]]:
        rsp = self._request({"op": "all_pairs", "tau": tau})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("error"))
        return [(a, b, s) for a, b, s in rsp["pairs"]]

    def topk(
        self, queries: Sequence[Tuple[str, SparseVector]], k: int
    ) -> Dict[str, List[Tuple[str, float]]]:
        rsp = self._request(
            {"op": "topk", "queries": vectors_to_wire(queries), "k": k}
        )
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("error"))
        return {q: [(c, s) for c, s in v] for q, v in rsp["topk"].items()}

    def stats(self) -> dict:
        rsp = self._request({"op": "stats"})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("error"))
        return rsp["stats"]

    def freeze(self) -> None:
        rsp = self._request({"op": "freeze"})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("error"))

    def flush(self) -> None:
        rsp = self._request({"op": "flush"})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("error"))

    def subscribe_outputs(
        self, callback: Callable[[Dict[str, Dict[str, float]], float], None]
    ) -> None:
        """Become the output actor: ``callback(output_map, output_moment)``
        fires for every SimilarityOutput the server emits.  Uses a dedicated
        event-stream connection so pushes never interleave with
        request/response traffic on this connection."""
        sub_sock = self._connect(None)
        sub_sock.settimeout(None)  # events may be sparse
        sub_file = sub_sock.makefile("r", encoding="utf-8")
        if self._auth_token is not None:
            sub_sock.sendall(
                (json.dumps({"op": "auth", "token": self._auth_token}) + "\n")
                .encode()
            )
            if not json.loads(sub_file.readline()).get("ok"):
                raise PermissionError("auth failed on subscription stream")
        sub_sock.sendall((json.dumps({"op": "subscribe"}) + "\n").encode())
        rsp = json.loads(sub_file.readline())
        if not rsp.get("subscribed"):
            raise RuntimeError("subscribe failed")
        self._sub_sock = sub_sock

        def loop() -> None:
            try:
                for line in sub_file:
                    msg = json.loads(line)
                    if msg.get("type") == "similarity_output":
                        callback(msg["output"], msg["output_moment"])
            except (OSError, ValueError):
                pass

        self._sub_thread = threading.Thread(target=loop, daemon=True)
        self._sub_thread.start()

    def close(self) -> None:
        for sock in (self._sock, getattr(self, "_sub_sock", None)):
            if sock is None:
                continue
            try:
                # shutdown() first: close() alone only drops THIS reference,
                # and the subscription reader thread's makefile() keeps the
                # fd alive — the server would never see the disconnect and
                # keep pushing to a zombie subscriber forever
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class InteractiveClient:
    """Terminal loop parity with Client.scala:61-94."""

    def __init__(self, conn: ClientConnection, out=None):
        self.conn = conn
        import sys

        self.out = out or sys.stdout

    def run(self, input_lines=None) -> None:
        import sys

        lines = iter(input_lines) if input_lines is not None else sys.stdin

        def next_line() -> str:
            line = next(lines, None)
            if line is None:
                return "quit"
            return line.strip()

        print("Terminal:", file=self.out)
        cmd = next_line()
        while cmd != "quit":
            if cmd == "start":
                table = next_line()
                start_key = int(next_line())
                end_key = int(next_line())
                print(
                    f"CLIENT: sending load {table} [{start_key}, {end_key}]",
                    file=self.out,
                )
                self.conn.load_data(table, start_key, end_key)
            elif cmd == "test":
                content = next_line()
                rsp = self.conn.test(content)
                print(f"test reply: {rsp}", file=self.out)
            elif cmd:
                print(cmd, file=self.out)
            cmd = next_line()
