"""TCP wire service: newline-delimited JSON over sockets.

The reference's network layer is Akka remote TCP with location-transparent
actor paths (``akka.tcp://ClusterSystem@host:port/user/regionRouter``,
ClientConnection.scala:19; conf/akka.conf:4-8).  The rebuild's equivalent
is a thin JSON-lines protocol in front of :class:`SimilarityServer` — the
message vocabulary maps 1:1 onto the reference's ``Message.scala``:

  {"op": "insert", "vectors": [[id, size, [dims], [vals]], ...]}
        → VectorIOMsg (Message.scala:13); fire-and-forget, NO reply
          (the reference's at-most-once ``!`` send)
  {"op": "load", "table": t, "start": a, "end": b}
        → LoadData (Message.scala:10); no reply
  {"op": "subscribe"}
        → registers this connection as the outputActor; the server pushes
          {"type": "similarity_output", "output": {...}, "output_moment": s}
          events (SimilarityOutput, Message.scala:20)
  {"op": "test", "content": c}   → Test (Message.scala:37); echoes back
  {"op": "all_pairs", "tau": t} / {"op": "topk", ...} / {"op": "stats"} /
  {"op": "freeze"} / {"op": "flush"}
        → request/response extensions (the reference had no query RPC).
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

from ..vector.sparse import SparseVector
from .server import SimilarityServer

__all__ = ["RpcServer", "wire_to_vectors", "vectors_to_wire"]


def wire_to_vectors(payload) -> list:
    out = []
    for vid, size, dims, vals in payload:
        out.append((str(vid), SparseVector(int(size), dims, vals)))
    return out


def vectors_to_wire(vectors) -> list:
    return [
        [vid, v.size, v.indices.tolist(), v.values.tolist()]
        for vid, v in vectors
    ]


class _Handler(socketserver.StreamRequestHandler):
    # bound per-request line size (64 MB ≈ a ~500k-nnz insert batch); an
    # unbounded readline would let one connection exhaust host memory
    MAX_LINE = 64 * 1024 * 1024

    def handle(self) -> None:
        srv: SimilarityServer = self.server.sim_server  # type: ignore[attr-defined]
        subscribed = False
        send_lock = threading.Lock()
        authed = not getattr(self.server, "auth_token", "")

        def push(out) -> None:
            msg = json.dumps(
                {
                    "type": "similarity_output",
                    "output": out.output,
                    "output_moment": out.output_moment,
                }
            )
            try:
                with send_lock:
                    self.wfile.write((msg + "\n").encode())
                    self.wfile.flush()
            except (OSError, ValueError) as e:
                # subscriber gone: OSError from a dead socket, ValueError
                # from the wfile socketserver closes after handle() returns
                # — either way, let the server unregister this sink
                raise BrokenPipeError(str(e)) from e

        def reply(obj) -> None:
            with send_lock:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

        try:
            while True:
                raw = self.rfile.readline(self.MAX_LINE + 2)
                if not raw:
                    break
                # payload bound: a complete MAX_LINE-byte line + '\n' is
                # fine; reject only when the PAYLOAD exceeds the bound
                if len(raw.rstrip(b"\n\r")) > self.MAX_LINE:
                    reply({"ok": False, "error": "request line too large"})
                    break
                raw = raw.strip()
                if not raw:
                    continue
                op = None
                try:
                    msg = json.loads(raw)
                    op = msg.get("op")
                    if not authed:
                        # shared-secret gate: nothing is processed (or even
                        # parsed into engine state) before a valid auth op
                        import hmac

                        if op == "auth" and hmac.compare_digest(
                            str(msg.get("token", "")),
                            getattr(self.server, "auth_token", ""),
                        ):
                            authed = True
                            reply({"ok": True, "authed": True})
                        else:
                            reply({"ok": False, "error": "unauthorized"})
                            break
                        continue
                    if op == "auth":
                        # re-auth on an authed session still VALIDATES the
                        # token (credential-rotation checks rely on it); a
                        # bad token is reported but doesn't kill the session
                        import hmac

                        tok_ok = hmac.compare_digest(
                            str(msg.get("token", "")),
                            getattr(self.server, "auth_token", ""),
                        ) or not getattr(self.server, "auth_token", "")
                        if tok_ok:
                            reply({"ok": True, "authed": True})
                        else:
                            reply({"ok": False, "error": "unauthorized"})
                    elif op in ("insert", "load"):
                        # fire-and-forget ops (the reference's at-most-once
                        # `!` sends) get NO reply — not even on error, which
                        # would desync a client's request/response stream;
                        # failures are logged and counted in stats["errors"]
                        try:
                            if op == "insert":
                                srv.insert_new_vectors(
                                    wire_to_vectors(msg["vectors"])
                                )
                            else:
                                srv.load_data(
                                    msg["table"],
                                    int(msg["start"]),
                                    int(msg["end"]),
                                )
                        except Exception as e:
                            srv.reject(f"{op}: {e}")
                    elif op == "subscribe":
                        if not subscribed:
                            subscribed = True
                            srv.add_output_sink(push)
                        reply({"ok": True, "subscribed": True})
                    elif op == "test":
                        # the Test message round-trip (Message.scala:37,
                        # IndexingWorkerActor.scala:145-147)
                        reply({"ok": True, "test": msg.get("content", "")})
                    elif op == "all_pairs":
                        res = srv.all_pairs(msg.get("tau"))
                        reply(
                            {
                                "ok": True,
                                "pairs": [
                                    [res.ids[int(a)], res.ids[int(b)], float(s)]
                                    for a, b, s in zip(res.i, res.j, res.sims)
                                ],
                            }
                        )
                    elif op == "topk":
                        res = srv.topk(
                            wire_to_vectors(msg["queries"]), int(msg["k"])
                        )
                        reply({"ok": True, "topk": res})
                    elif op == "stats":
                        reply({"ok": True, "stats": srv.stats()})
                    elif op == "freeze":
                        srv.freeze()
                        reply({"ok": True})
                    elif op == "flush":
                        srv.flush()
                        reply({"ok": True})
                    else:
                        reply({"ok": False, "error": f"unknown op: {op}"})
                except Exception as e:  # malformed request never kills the server
                    if op in ("insert", "load"):
                        srv.reject(f"{op}: {e}")  # no reply: see above
                        continue
                    try:
                        reply({"ok": False, "error": str(e)})
                    except OSError:
                        break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            # unregister on disconnect: waiting for the next emission to
            # BrokenPipe the sink lets an idle server accumulate dead
            # subscriber closures (and their sockets) without bound
            if subscribed:
                srv.remove_output_sink(push)


class _TcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    ssl_context = None

    def finish_request(self, request, client_address):
        # TLS handshake happens HERE, on the per-connection thread — doing
        # it in get_request would run it on the single accept thread, where
        # one client that connects and never sends a ClientHello blocks
        # every other connection (a trivial DoS on exactly the non-loopback
        # deployments TLS exists for).  Bounded by a handshake timeout.
        if self.ssl_context is not None:
            try:
                request.settimeout(20.0)
                request = self.ssl_context.wrap_socket(
                    request, server_side=True
                )
                request.settimeout(None)
            except OSError:
                try:
                    request.close()
                except OSError:
                    pass
                return
        super().finish_request(request, client_address)


class RpcServer:
    """Lifecycle wrapper: serve a SimilarityServer on host:port.

    TLS (``tls_cert``/``tls_key`` config) and a shared-secret auth gate
    (``auth_token``) extend the reference's plaintext, unauthenticated Akka
    remote for non-loopback deployments."""

    def __init__(self, sim_server: SimilarityServer, host: str = "127.0.0.1",
                 port: int = 0):
        self.sim_server = sim_server
        self._tcp = _TcpServer((host, port), _Handler)
        self._tcp.sim_server = sim_server  # type: ignore[attr-defined]
        cfg = sim_server.cfg
        self._tcp.auth_token = getattr(  # type: ignore[attr-defined]
            cfg, "auth_token", ""
        )
        cert, key = getattr(cfg, "tls_cert", ""), getattr(cfg, "tls_key", "")
        if cert and key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            self._tcp.ssl_context = ctx  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RpcServer":
        self.sim_server.start()
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        # shutdown() waits on an event only serve_forever() sets — calling
        # it on a never-started server would block forever
        if self._thread is not None:
            self._tcp.shutdown()
        self._tcp.server_close()
        self.sim_server.close()

    def __enter__(self) -> "RpcServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
