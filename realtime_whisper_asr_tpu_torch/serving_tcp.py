"""TCP line-protocol serving: network clients stream PCM, receive text lines.

Port of ``realtime_whisper_asr_tpu/serving_tcp.py``. The whisper_streaming
ecosystem ships a socket server speaking a simple protocol (raw 16 kHz
s16le PCM in, ``"beg_ms end_ms text"`` lines out); this adapter exposes the
multi-stream StreamServer (serving.py) over the same wire format.

One thread per connection feeds the shared server; the server's round-robin
thread does all the card's work. Line protocol per result:

    <begin_ms> <end_ms> <text>\\n

Shutdown of a connection flushes its stream (close_stream final tick).

    python -m realtime_whisper_asr_tpu_torch.serving_tcp --model large-v3 --port 43007
"""

from __future__ import annotations

import argparse
import logging
import socket
import socketserver
import threading

import numpy as np

logger = logging.getLogger(__name__)

PCM_CHUNK_BYTES = 2 * 16000  # 1 s of s16le mono @16 kHz


def _pcm_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server: TCPTranscriptionServer = self.server  # type: ignore[assignment]
        sid = server.stream_server.create_stream(language=server.language)
        logger.info("connection %s -> stream %d", self.client_address, sid)
        sock: socket.socket = self.request
        sock.settimeout(0.2)
        buf = bytearray()  # O(1) appends; bytes += re-copies the backlog
        try:
            while not server.stopping.is_set():
                try:
                    data = sock.recv(65536)
                    if not data:
                        break
                    buf += data
                except socket.timeout:
                    data = None
                while len(buf) >= PCM_CHUNK_BYTES:
                    chunk = bytes(buf[:PCM_CHUNK_BYTES])
                    del buf[:PCM_CHUNK_BYTES]
                    server.stream_server.feed(sid, _pcm_to_float(chunk))
                if not self._send_results(sock, server, sid):
                    break  # send failed mid-line: the wire is corrupt, stop
        except (ConnectionError, ValueError):
            pass
        finally:
            if buf:
                try:
                    server.stream_server.feed(
                        sid, _pcm_to_float(bytes(buf[: len(buf) // 2 * 2])))
                except ValueError:
                    pass
            try:
                final = server.stream_server.close_stream(sid)
                self._emit(sock, final)
            except (ValueError, ConnectionError, OSError):
                pass
            logger.info("stream %d closed", sid)

    def _send_results(self, sock, server, sid) -> bool:
        return self._emit(sock, server.stream_server.poll(sid))

    @staticmethod
    def _emit(sock, results) -> bool:
        """Send result lines; False when the connection is no longer usable.
        A timed-out ``sendall`` may have PARTIALLY written a line (socket
        docs) — continuing would append the next line into the truncated one
        and garble the protocol, so the caller must drop the client."""
        for r in results:
            # the whisper_streaming wire format is fixed; a speaker label
            # rides as a [S<n>] text prefix so existing clients keep parsing
            spk = f"[{r.speaker}] " if getattr(r, "speaker", None) else ""
            line = f"{int(r.begin * 1000)} {int(r.end * 1000)} {spk}{r.text.strip()}\n"
            try:
                sock.sendall(line.encode("utf-8"))
            except OSError:  # includes ConnectionError and send timeouts
                return False
        return True


class TCPTranscriptionServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, stream_server, language=None):
        super().__init__(address, _Handler)
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


def _parser(description: str, port: int) -> argparse.ArgumentParser:
    """The serving CLIs' flags (TCP and WebSocket)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=port)
    p.add_argument("--model", default="large-v3-turbo")
    p.add_argument("--language", default="en")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory: the port's native format or the HF layout "
                        "(config.json + *.safetensors); --model is then ignored")
    p.add_argument("--quantization", default="int8-all",
                   choices=["int8-all", "int8", "int8-kv", "none"],
                   help="int8-all: int8 encoder, decoder and head; int8-kv: int8-all plus "
                        "int8 KV caches; a pre-quantized checkpoint is never weakened")
    p.add_argument("--prefix-policy", default="last", choices=["agree2", "last"])
    p.add_argument("--device", default="cuda", help="the model's device (cpu: the plain path)")
    p.add_argument("--diarize", action="store_true",
                   help="per-stream speaker-turn tracking (labels in results)")
    p.add_argument("--separation", default="none", choices=["none", "filter", "neural"],
                   help="vocal-separation frontend: neural fuses the trained net into the "
                        "encode on the model's device; filter band-passes every fed chunk "
                        "on the host, on the connection's thread")
    p.add_argument("--separation-variant", default="small", choices=["default", "small"],
                   help="neural variant; small (~2.6x fewer MACs) is the many-stream "
                        "recommendation")
    return p


def _stream_server(args):
    """A StreamServer over ``TorchWhisperASR`` in bf16 on the card, as
    ``args`` ask (``--checkpoint`` loads a directory, else ``--model``'s
    random weights), with speaker labels under ``--diarize`` and the
    ``--separation`` frontend."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.pipeline.separation import create_separator
    from realtime_whisper_asr_tpu_torch.serving import StreamServer

    asr = TorchWhisperASR(model_size=args.model, language=args.language, dtype=torch.bfloat16,
                          device=args.device, quantization=args.quantization,
                          checkpoint_dir=args.checkpoint)
    separator = create_separator(args.separation, use_device=False,
                                 variant=args.separation_variant, device=args.device)
    return StreamServer(asr, prefix_policy=args.prefix_policy, diarize=args.diarize,
                        separator=separator)


def main(argv=None) -> int:  # pragma: no cover - thin CLI
    args = _parser("TCP streaming transcription server", 43007).parse_args(argv)
    server = TCPTranscriptionServer((args.host, args.port), _stream_server(args),
                                    language=args.language)
    print(f"listening on {args.host}:{args.port} (model={args.model})")
    server.serve()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
