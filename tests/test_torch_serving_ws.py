"""The WebSocket adapter over both packages: RFC6455 framing and end to end.

``tests/test_serving_ws.py``'s cases, each run against the JAX package's
``serving_ws`` (over its ``StreamServer``) and the port's
(``realtime_whisper_asr_tpu_torch.serving_ws`` over its own), with
``tests/test_serving.py``'s ``PerStreamFakeASR``: ``accept_key``, the frame
round trip, end to end over a real socket, frames pipelined behind the
handshake, the rejection of a non-WebSocket request, the speaker field and
the oversize cap.
"""

import json
import socket
import struct
import threading
import time as _t
import types

import numpy as np
import pytest

import realtime_whisper_asr_tpu.serving as JS
import realtime_whisper_asr_tpu.serving_ws as JW
import realtime_whisper_asr_tpu_torch.serving as PS
import realtime_whisper_asr_tpu_torch.serving_ws as PW
from tests.test_serving import PerStreamFakeASR
from tests.test_streaming import timecoded_audio

PACKAGES = {"jax": (JS, JW), "torch": (PS, PW)}


@pytest.fixture(params=list(PACKAGES))
def ws(request):
    """The package's serving_ws module, with its StreamServer and StreamResult."""
    serving, mod = PACKAGES[request.param]
    return types.SimpleNamespace(**{k: getattr(mod, k) for k in dir(mod) if not k.startswith("__")},
                                 StreamServer=serving.StreamServer,
                                 StreamResult=serving.StreamResult)


def test_accept_key_rfc_example(ws):
    # the worked example from RFC 6455 §1.3
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_frame_roundtrip_masked_and_fragmented(ws):
    r = ws._FrameReader()
    # masked single frame (client style)
    r.push(ws.encode_frame(ws.OP_BINARY, b"abcdef", mask=True))
    assert r.next_message() == (ws.OP_BINARY, b"abcdef")
    # large frame (16-bit length path)
    big = bytes(range(256)) * 300
    r.push(ws.encode_frame(ws.OP_BINARY, big, mask=True))
    assert r.next_message() == (ws.OP_BINARY, big)
    # fragmented text message: FIN=0 TEXT + FIN=1 CONT
    f1 = bytearray(ws.encode_frame(ws.OP_TEXT, b"hel"))
    f1[0] &= 0x7F  # clear FIN
    f2 = ws.encode_frame(0x0, b"lo")
    r.push(bytes(f1))
    assert r.next_message() is None
    r.push(f2)
    assert r.next_message() == (ws.OP_TEXT, b"hello")
    # partial delivery: byte-by-byte
    frame = ws.encode_frame(ws.OP_BINARY, b"xyz", mask=True)
    for byte in frame[:-1]:
        r.push(bytes([byte]))
        assert r.next_message() is None
    r.push(frame[-1:])
    assert r.next_message() == (ws.OP_BINARY, b"xyz")


def _ws_handshake(ws, sock: socket.socket) -> None:
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    req = (
        "GET / HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\n"
        "Connection: Upgrade\r\nSec-WebSocket-Key: " + key +
        "\r\nSec-WebSocket-Version: 13\r\n\r\n"
    )
    sock.sendall(req.encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    assert b"101" in resp.split(b"\r\n", 1)[0]
    assert ws.accept_key(key).encode() in resp


def test_ws_server_end_to_end(ws):
    """Handshake, PCM binary frames in, JSON text frames out, clean close."""
    words = {1: [(0.5, 0.9, " hello"), (1.2, 1.6, " websocket")]}
    stream_server = ws.StreamServer(PerStreamFakeASR(words), use_vad=False,
                                 online_chunk_size=0.5)
    srv = ws.WSTranscriptionServer(("127.0.0.1", 0), stream_server)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        _ws_handshake(ws, sock)
        pcm = (np.clip(timecoded_audio(0.0, 3.0), -1, 1) * 32768).astype(np.int16)
        # send in odd-sized binary frames to exercise re-chunking
        raw = pcm.tobytes()
        for i in range(0, len(raw), 30000):
            sock.sendall(ws.encode_frame(ws.OP_BINARY, raw[i : i + 30000], mask=True))
        sock.sendall(ws.encode_frame(ws.OP_PING, b"hb", mask=True))
        _t.sleep(0.5)
        sock.sendall(ws.encode_frame(ws.OP_CLOSE, struct.pack(">H", 1000), mask=True))
        sock.settimeout(5)
        reader = ws._FrameReader()
        texts, got_pong, got_close = [], False, False
        try:
            while not got_close:
                data = sock.recv(4096)
                if not data:
                    break
                reader.push(data)
                while True:
                    msg = reader.next_message()
                    if msg is None:
                        break
                    op, payload = msg
                    if op == ws.OP_TEXT:
                        texts.append(json.loads(payload.decode("utf-8")))
                    elif op == ws.OP_PONG:
                        got_pong = payload == b"hb"
                    elif op == ws.OP_CLOSE:
                        got_close = True
        except socket.timeout:
            pass
        all_text = "".join(r["text"] for r in texts)
        assert "hello" in all_text and "websocket" in all_text, texts
        assert got_pong
        assert got_close
        for r in texts:
            assert r["begin_ms"] <= r["end_ms"]
            assert isinstance(r["final"], bool)
    finally:
        srv.shutdown()
        t.join(timeout=5)


def test_ws_pipelined_handshake_frames_not_lost(ws):
    """Bytes an eager client pipelines behind its handshake (even a frame that
    straddles the first send) must seed the frame parser, not be discarded."""
    stream_server = ws.StreamServer(PerStreamFakeASR({1: []}), use_vad=False)
    srv = ws.WSTranscriptionServer(("127.0.0.1", 0), stream_server)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        key = "dGhlIHNhbXBsZSBub25jZQ=="
        req = (
            "GET / HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\n"
            "Connection: Upgrade\r\nSec-WebSocket-Key: " + key +
            "\r\nSec-WebSocket-Version: 13\r\n\r\n"
        ).encode()
        ping1 = ws.encode_frame(ws.OP_PING, b"early", mask=True)
        ping2 = ws.encode_frame(ws.OP_PING, b"late", mask=True)
        # handshake + whole first frame + a SPLIT second frame in one send
        sock.sendall(req + ping1 + ping2[:3])
        _t.sleep(0.1)
        sock.sendall(ping2[3:])
        sock.settimeout(5)
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += sock.recv(4096)
        rest = resp.split(b"\r\n\r\n", 1)[1]
        reader = ws._FrameReader()
        reader.push(rest)
        pongs = []
        try:
            while len(pongs) < 2:
                msg = reader.next_message()
                if msg is None:
                    data = sock.recv(4096)
                    if not data:
                        break
                    reader.push(data)
                    continue
                if msg[0] == ws.OP_PONG:
                    pongs.append(msg[1])
        except socket.timeout:
            pass
        assert pongs == [b"early", b"late"], pongs
    finally:
        srv.shutdown()
        t.join(timeout=5)


def test_ws_rejects_non_websocket_request(ws):
    stream_server = ws.StreamServer(PerStreamFakeASR({1: []}), use_vad=False)
    srv = ws.WSTranscriptionServer(("127.0.0.1", 0), stream_server)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        sock.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        resp = sock.recv(4096)
        assert b"400" in resp
    finally:
        srv.shutdown()
        t.join(timeout=5)


def test_ws_emit_includes_speaker_field(ws):
    """WS results carry a 'speaker' key only when diarization labeled them."""
    sent = []

    class Sock:
        def sendall(self, b):
            sent.append(bytes(b))

    ws._WSHandler._emit(Sock(), [
        ws.StreamResult(1, 0.0, 1.0, "hello", speaker="S2"),
        ws.StreamResult(1, 1.0, 2.0, "world"),
    ])
    reader = ws._FrameReader()
    reader.push(b"".join(sent))
    msgs = []
    while True:
        m = reader.next_message()
        if m is None:
            break
        msgs.append(m[1])
    objs = [json.loads(m) for m in msgs]
    assert objs[0]["speaker"] == "S2"
    assert "speaker" not in objs[1]


def test_frame_reader_rejects_oversized_declared_payload(ws):
    """A hostile 64-bit length header (e.g. 2^40) must raise a protocol error
    instead of buffering recv data forever toward the declared size — the
    handler maps ValueError to a clean connection drop."""
    r = ws._FrameReader()
    head = bytes([0x82, 0x80 | 127]) + struct.pack(">Q", 1 << 40) + b"\x00\x00\x00\x00"
    r.push(head)
    with pytest.raises(ValueError):
        r.next_message()

    # a legitimate large-but-capped frame still parses
    r2 = ws._FrameReader()
    payload = b"x" * 200_000
    assert len(payload) < ws.MAX_WS_PAYLOAD
    r2.push(ws.encode_frame(ws.OP_BINARY, payload, mask=True))
    op, got = r2.next_message()
    assert op == ws.OP_BINARY and got == payload
