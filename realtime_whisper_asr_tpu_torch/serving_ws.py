"""WebSocket serving adapter: browsers stream PCM, receive JSON results.

Port of ``realtime_whisper_asr_tpu/serving_ws.py``: the counterpart to the
TCP line-protocol adapter (serving_tcp.py) for web clients, built
RFC6455-minimal on the stdlib:

- handshake: HTTP/1.1 Upgrade with Sec-WebSocket-Accept (SHA1+base64 of the
  client key + the RFC GUID)
- client → server: BINARY frames carrying 16 kHz s16le mono PCM (any frame
  size; re-chunked internally), client frames MUST be masked per the RFC
- server → client: TEXT frames with one JSON object per result
  ``{"begin_ms": int, "end_ms": int, "text": str, "final": bool}``
- PING answered with PONG; CLOSE (or EOF) flushes the stream and replies
  with CLOSE

One thread per connection feeds the shared multi-stream StreamServer
(serving.py); the server's scheduler thread does all the card's work,
batching same-language streams into single decodes.

    python -m realtime_whisper_asr_tpu_torch.serving_ws --model large-v3 --port 43008
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import socket
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

# the PCM wire format and the CLI have ONE definition, shared with the TCP adapter
from realtime_whisper_asr_tpu_torch.serving_tcp import (
    PCM_CHUNK_BYTES,
    _parser,
    _pcm_to_float,
    _stream_server,
)


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """Serialize one unfragmented frame (server frames are unmasked; the
    ``mask`` path exists for test clients, which the RFC requires to mask)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < 1 << 16:
        head += bytes([mbit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack(">Q", n)
    if mask:
        key = np.random.randint(0, 256, 4, dtype=np.uint8).tobytes()
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return head + key + masked
    return head + payload


#: largest accepted frame payload / fragmented-message size. Audio frames are
#: ~32 KB/s of PCM, results are small JSON — 16 MB is far beyond any legitimate
#: client, and a cap turns a hostile 2^40-length header (which would otherwise
#: buffer recv data forever) into a clean protocol error that drops the client.
MAX_WS_PAYLOAD = 16 << 20


class _FrameReader:
    """Incremental frame decoder over a byte stream; handles fragmentation.
    Raises ``ValueError`` on frames/messages over MAX_WS_PAYLOAD (the handler
    treats that as a protocol error and closes the connection)."""

    def __init__(self):
        self.buf = bytearray()  # O(1) appends; bytes += re-copies the backlog
        self._frag_op: int | None = None
        self._frag_data = b""

    def push(self, data: bytes):
        self.buf += data
        # 14 bytes covers the largest header (2 + 8 len + 4 mask)
        if len(self.buf) > MAX_WS_PAYLOAD + 14:
            raise ValueError(f"ws receive buffer exceeded {MAX_WS_PAYLOAD} bytes")

    def next_message(self):
        """Return (opcode, payload) for the next COMPLETE message, else None."""
        while True:
            parsed = self._next_frame()
            if parsed is None:
                return None
            fin, opcode, payload = parsed
            if opcode in (OP_CLOSE, OP_PING, OP_PONG):  # control: never fragmented
                return opcode, payload
            if opcode == OP_CONT:
                self._frag_data += payload
                if len(self._frag_data) > MAX_WS_PAYLOAD:
                    raise ValueError("fragmented ws message exceeds payload cap")
                if fin and self._frag_op is not None:
                    msg = (self._frag_op, self._frag_data)
                    self._frag_op, self._frag_data = None, b""
                    return msg
                continue
            if fin:
                return opcode, payload
            self._frag_op, self._frag_data = opcode, payload

    def _next_frame(self):
        buf = self.buf
        if len(buf) < 2:
            return None
        fin = bool(buf[0] & 0x80)
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < pos + 2:
                return None
            (n,) = struct.unpack(">H", buf[pos : pos + 2])
            pos += 2
        elif n == 127:
            if len(buf) < pos + 8:
                return None
            (n,) = struct.unpack(">Q", bytes(buf[pos : pos + 8]))
            pos += 8
        if n > MAX_WS_PAYLOAD:
            raise ValueError(f"ws frame declares {n} bytes > cap {MAX_WS_PAYLOAD}")
        key = b""
        if masked:
            if len(buf) < pos + 4:
                return None
            key = buf[pos : pos + 4]
            pos += 4
        if len(buf) < pos + n:
            return None
        payload = bytes(buf[pos : pos + n])
        self.buf = buf[pos + n :]
        if masked and n:
            data = np.frombuffer(payload, np.uint8)
            mask = np.frombuffer((key * (n // 4 + 1))[:n], np.uint8)
            payload = (data ^ mask).tobytes()
        return fin, opcode, payload


class _WSHandler(socketserver.BaseRequestHandler):
    def handle(self):
        server: WSTranscriptionServer = self.server  # type: ignore[assignment]
        sock: socket.socket = self.request
        rest = self._handshake(sock)
        if rest is None:
            return
        sid = server.stream_server.create_stream(language=server.language)
        logger.info("ws connection %s -> stream %d", self.client_address, sid)
        reader = _FrameReader()
        if rest:
            # bytes an eager client pipelined behind its handshake: frames (or
            # a frame fragment) must seed the parser or it permanently desyncs
            reader.push(rest)
        pcm = bytearray()
        sock.settimeout(0.2)
        closed = False
        try:
            while not server.stopping.is_set():
                try:
                    data = sock.recv(65536)
                    if not data:
                        break
                    reader.push(data)
                except socket.timeout:
                    pass
                while True:
                    msg = reader.next_message()
                    if msg is None:
                        break
                    op, payload = msg
                    if op == OP_BINARY:
                        pcm += payload
                    elif op == OP_PING:
                        try:
                            sock.sendall(encode_frame(OP_PONG, payload))
                        except OSError:
                            # a timed-out sendall may have written a PARTIAL
                            # frame — the stream is desynced, drop the client
                            closed = True
                            break
                    elif op == OP_CLOSE:
                        closed = True
                        break
                while len(pcm) >= PCM_CHUNK_BYTES:
                    chunk = bytes(pcm[:PCM_CHUNK_BYTES])
                    del pcm[:PCM_CHUNK_BYTES]
                    server.stream_server.feed(sid, _pcm_to_float(chunk))
                if not self._emit(sock, server.stream_server.poll(sid)):
                    break  # partial frame on the wire: unrecoverable desync
                if closed:
                    break
        except (ConnectionError, ValueError):
            pass
        finally:
            if pcm:
                try:
                    server.stream_server.feed(
                        sid, _pcm_to_float(bytes(pcm[: len(pcm) // 2 * 2])))
                except ValueError:
                    pass
            try:
                final = server.stream_server.close_stream(sid)
                self._emit(sock, final, final_flag=True)
                sock.sendall(encode_frame(OP_CLOSE, struct.pack(">H", 1000)))
            except (ValueError, ConnectionError, OSError):
                pass
            logger.info("ws stream %d closed", sid)

    def _handshake(self, sock: socket.socket) -> Optional[bytes]:
        """Perform the HTTP upgrade. Returns any bytes received AFTER the
        header terminator (an eager client's pipelined first frames) so the
        caller can seed the frame parser with them, or None on failure."""
        sock.settimeout(5.0)
        data = b""
        try:
            while b"\r\n\r\n" not in data:
                part = sock.recv(4096)
                if not part:
                    return None
                data += part
                if len(data) > 65536:
                    return None
        except (socket.timeout, ConnectionError):
            return None
        head_raw, rest = data.split(b"\r\n\r\n", 1)
        head = head_raw.decode("latin1")
        headers = {}
        for line in head.split("\r\n")[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if not key or "websocket" not in headers.get("upgrade", "").lower():
            sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
            return None
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
        )
        sock.sendall(resp.encode("latin1"))
        return rest

    @staticmethod
    def _emit(sock, results, final_flag: bool = False) -> bool:
        """Send result frames; False when the connection is no longer usable.
        A timed-out ``sendall`` may have PARTIALLY written a frame (socket
        docs) — the next frame header would land mid-payload and desync the
        client's parser permanently, so the caller must drop the client."""
        for r in results:
            obj = {"begin_ms": int(r.begin * 1000), "end_ms": int(r.end * 1000),
                   "text": r.text.strip(), "final": final_flag}
            if getattr(r, "speaker", None):
                obj["speaker"] = r.speaker
            try:
                sock.sendall(encode_frame(OP_TEXT, json.dumps(obj).encode("utf-8")))
            except OSError:  # includes ConnectionError and send timeouts
                return False
        return True


class WSTranscriptionServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, stream_server, language=None):
        super().__init__(address, _WSHandler)
        self.stream_server = stream_server
        self.language = language
        self.stopping = threading.Event()

    def serve(self):
        """Run the scheduler and the accept loop until shutdown() is called."""
        self.stream_server.start()
        try:
            self.serve_forever(poll_interval=0.1)
        finally:
            self.stopping.set()
            self.stream_server.stop()


def main(argv=None) -> int:  # pragma: no cover - thin CLI
    args = _parser("WebSocket streaming transcription server", 43008).parse_args(argv)
    server = WSTranscriptionServer((args.host, args.port), _stream_server(args),
                                   language=args.language)
    print(f"ws listening on {args.host}:{args.port} (model={args.model})")
    server.serve()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
