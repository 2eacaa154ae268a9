"""HTTP serving frontend for the synthesis stack.

Counterpart of ``emotts/infer/server.py``: a long-lived process that keeps
the models resident on the device and answers requests, with three
endpoints over the existing engines:

* ``GET /health`` — liveness + the model's speaker/emotion tables.
* ``POST /synthesize`` — one long-form request → a complete ``audio/wav``
  body (``Synthesizer.synthesize_text``: sentence-split, bucket-batched,
  O(#buckets) device forwards).  With ``"stream": true`` the answer is a
  chunked ``audio/L16`` body (16-bit little-endian mono PCM, rate in
  ``X-Sample-Rate``) whose chunks leave as they are vocoded
  (``emotts_torch.infer.streaming.stream_text``).
* ``POST /batch`` — many requests in one body; all sentences across all
  requests that share a phone bucket run as ONE forward
  (``Synthesizer.synthesize_requests``), so device work is O(#distinct
  buckets), not O(#requests).

Single-process, stdlib-only (``ThreadingHTTPServer``): connection handling
is threaded, device work serializes through one lock.  Concurrent plain
``/synthesize`` requests do NOT serialize one engine call each: a
micro-batcher collects requests that arrive within a short window (and
everything that accumulates while a previous batch is on the device) and
feeds them through ``Synthesizer.synthesize_requests`` as one batch.
Requests with different prosody rates (pace/pitch/energy) group into
separate engine calls per rate tuple.  SSML requests bypass the batcher.

Speakers/emotions accept either names (from ``cfg.data``) or integer ids.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import numpy as np
import torch


def _pcm16(y: np.ndarray) -> bytes:
    return (np.clip(y, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def _wav_bytes(y: np.ndarray, sr: int) -> bytes:
    """float32 [-1, 1] → 16-bit PCM WAV container bytes."""
    pcm = (np.clip(y, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class TTSRequestError(ValueError):
    pass


class _MicroBatcher:
    """Cross-request micro-batching for plain synthesis requests.

    One daemon worker drains a shared queue: it waits for the first
    request, sleeps a short collection window so concurrent arrivals can
    join, then snapshots the queue and runs ONE
    ``Synthesizer.synthesize_requests`` dispatch per distinct prosody-rate
    tuple.  While that dispatch is on the device, new arrivals keep
    accumulating and form the next batch — so under load, batch size
    adapts to however many requests one device round-trip takes to serve.
    Submitting threads block on a per-request event; engine errors
    propagate to every request of the failing group only.
    """

    def __init__(self, service, window_s: float = 0.005,
                 max_batch: int = 64):
        self.service = service
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._cv = threading.Condition()
        self._queue: list = []
        self._worker = threading.Thread(
            target=self._run, name="tts-microbatch", daemon=True
        )
        self._worker.start()

    def submit(self, parsed: dict) -> np.ndarray:
        item = {"req": parsed, "done": threading.Event(),
                "result": None, "error": None}
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
            if self.window_s > 0:
                time.sleep(self.window_s)  # let concurrent arrivals join
            with self._cv:
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        # prosody rates are shared per engine call — group by the rate
        # tuple so mixed-rate batches stay correct
        groups: dict = {}
        for item in batch:
            r = item["req"]
            key = (r["pace"], r["pitch_rate"], r["energy_rate"])
            groups.setdefault(key, []).append(item)
        for (pace, pr, er), items in groups.items():
            try:
                with self.service.lock:
                    wavs = self.service.synth.synthesize_requests(
                        [it["req"] for it in items],
                        pace=pace, pitch_rate=pr, energy_rate=er,
                    )
                for it, wav in zip(items, wavs):
                    it["result"] = wav
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for it in items:
                    it["error"] = e
            finally:
                for it in items:
                    it["done"].set()


class TTSService:
    """Name resolution + request validation + serialized engine access."""

    def __init__(self, cfg, synth, microbatch_window_ms: float = 5.0,
                 device: str = "cuda"):
        # the service states where it expects its engine to run, so that a
        # deployment cannot end up serving from the CPU unnoticed
        want = torch.device(device).type
        if want == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TTSService(device='cuda') needs an NVIDIA GPU and none is "
                "visible; pass device='cpu' to serve the plain PyTorch path"
            )
        if synth.device.type != want:
            raise ValueError(
                f"the service was asked for device {device!r} but its "
                f"Synthesizer runs on {synth.device}"
            )
        self.cfg = cfg
        self.synth = synth
        self.lock = threading.Lock()  # device work serializes here
        self.speakers = list(cfg.data.speakers)
        self.emotions = list(cfg.data.emotions)
        # window < 0 disables cross-request batching (direct engine calls)
        self.batcher = (
            _MicroBatcher(self, window_s=microbatch_window_ms / 1000.0)
            if microbatch_window_ms >= 0 else None
        )

    def _resolve(self, value, table, what: str) -> int:
        from emotts_torch.infer.synthesize import resolve_name

        try:
            return resolve_name(value, table, what)
        except ValueError as e:
            raise TTSRequestError(str(e)) from None

    def parse(self, req: dict) -> dict:
        if not isinstance(req, dict) or not (
            str(req.get("text", "")).strip()
            or str(req.get("ssml", "")).strip()
        ):
            raise TTSRequestError("request needs a non-empty 'text' or 'ssml'")
        if str(req.get("ssml", "")).strip():
            if req.get("speaker_mix") or req.get("emotion_mix"):
                raise TTSRequestError(
                    "'ssml' cannot combine with speaker_mix/emotion_mix — "
                    "use <voice>/<emotion> spans inside the markup"
                )
            req = dict(req)
            req.setdefault("speaker", 0)
            req.setdefault("emotion", 0)
            req["text"] = ""  # unused on the SSML path
        spk_mix = req.get("speaker_mix")
        emo_mix = req.get("emotion_mix")
        out = {
            "text": str(req["text"]),
            "speaker": (0 if spk_mix else
                        self._resolve(req.get("speaker"), self.speakers,
                                      "speaker")),
            "emotion": (0 if emo_mix else
                        self._resolve(req.get("emotion"), self.emotions,
                                      "emotion")),
            "level": float(req.get("level", 0)),
            "scale": float(req.get("intensity_scale", 1.0)),
            "pace": float(req.get("pace", 1.0)),
            "pitch_rate": float(req.get("pitch_rate", 1.0)),
            "energy_rate": float(req.get("energy_rate", 1.0)),
        }
        # blended controls: {"speaker_mix": {"bea": 0.5, "josh": 0.5}},
        # {"emotion_mix": {"amused": 0.6, "sleepy": 0.4}} (names or ids;
        # weights renormalize in the Synthesizer)
        if spk_mix:
            if not isinstance(spk_mix, dict) or not spk_mix:
                raise TTSRequestError("'speaker_mix' must be {name: weight}")
            out["speaker_mix"] = [
                (self._resolve(k, self.speakers, "speaker"), float(w))
                for k, w in spk_mix.items()
            ]
        if emo_mix:
            if not isinstance(emo_mix, dict) or not emo_mix:
                raise TTSRequestError("'emotion_mix' must be {name: weight}")
            out["emotion_mix"] = [
                (self._resolve(k, self.emotions, "emotion"), out["level"],
                 float(w))
                for k, w in emo_mix.items()
            ]
        if str(req.get("ssml", "")).strip():
            out["ssml"] = str(req["ssml"])
        return out

    def _need_vocoder(self):
        if self.synth.vocoder_params is None:
            raise TTSRequestError(
                "server has no vocoder configured "
                "(set inference.vocoder_checkpoint)"
            )

    def synthesize(self, req: dict) -> np.ndarray:
        self._need_vocoder()
        r = self.parse(req)
        if r.get("ssml"):
            from emotts_torch.text.ssml import SSMLError

            try:
                with self.lock:
                    return self.synth.synthesize_ssml(
                        r["ssml"], speaker=r["speaker"],
                        emotion=r["emotion"], level=r["level"],
                        intensity_scale=r["scale"], pace=r["pace"],
                        pitch_rate=r["pitch_rate"],
                        energy_rate=r["energy_rate"],
                    )
            except SSMLError as e:
                raise TTSRequestError(str(e))
        if self.batcher is not None:
            # cross-request micro-batching: concurrent requests coalesce
            # into one synthesize_requests dispatch
            return self.batcher.submit(r)
        with self.lock:
            return self.synth.synthesize_text(
                r["text"], r["speaker"], r["emotion"], level=r["level"],
                intensity_scale=r["scale"], pace=r["pace"],
                pitch_rate=r["pitch_rate"], energy_rate=r["energy_rate"],
                speaker_mix=r.get("speaker_mix"),
                emotion_mix=r.get("emotion_mix"),
            )

    def stream(self, req: dict):
        """A generator of float32 chunks for ``req``.  All validation happens
        here, eagerly: once the handler has started a chunked 200 response,
        an error inside the generator can no longer become a 400."""
        from emotts_torch.infer.streaming import stream_text

        self._need_vocoder()
        r = self.parse(req)
        if "speaker_mix" in r or "emotion_mix" in r or r.get("ssml"):
            raise TTSRequestError(
                "speaker_mix/emotion_mix/ssml are not supported on the "
                "streaming path yet"
            )

        def gen():
            with self.lock:
                # yield under the lock: chunks come straight off the device
                yield from stream_text(
                    self.synth, r["text"], r["speaker"], r["emotion"],
                    level=r["level"], intensity_scale=r["scale"],
                    pace=r["pace"], pitch_rate=r["pitch_rate"],
                    energy_rate=r["energy_rate"],
                )

        return gen()

    def batch(self, reqs) -> list:
        self._need_vocoder()
        if not isinstance(reqs, list) or not reqs:
            raise TTSRequestError("'requests' must be a non-empty list")
        parsed = [self.parse(r) for r in reqs]
        if any(r.get("ssml") for r in parsed):
            raise TTSRequestError(
                "'ssml' requests are not supported on /batch — "
                "POST them to /synthesize individually"
            )
        # prosody rates are shared per engine call
        # (Synthesizer.synthesize_requests); a batch uses the first
        # request's values — split calls to mix prosody
        first = parsed[0]
        with self.lock:
            return self.synth.synthesize_requests(
                parsed, pace=first["pace"], pitch_rate=first["pitch_rate"],
                energy_rate=first["energy_rate"],
            )


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # self.server.service is attached by make_server

    def log_message(self, fmt, *args):  # route through server hook (quiet tests)
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # -- helpers ---------------------------------------------------------

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            raise TTSRequestError("missing request body")
        try:
            return json.loads(self.rfile.read(n))
        except json.JSONDecodeError as e:
            raise TTSRequestError(f"bad JSON: {e}") from e

    # -- endpoints -------------------------------------------------------

    def do_GET(self):
        svc: TTSService = self.server.service
        if self.path == "/health":
            self._json(200, {
                "status": "ok",
                "speakers": svc.speakers,
                "emotions": svc.emotions,
                "sample_rate": svc.cfg.audio.sampling_rate,
                "vocoder": svc.synth.vocoder_params is not None,
            })
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        svc: TTSService = self.server.service
        sr = svc.cfg.audio.sampling_rate
        try:
            if self.path == "/synthesize":
                req = self._read_json()
                if req.get("stream"):
                    # svc.stream validates before the chunked 200 starts,
                    # while a 400 can still be sent
                    chunks = svc.stream(req)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/L16")
                    self.send_header("X-Sample-Rate", str(sr))
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for chunk in chunks:
                        data = _pcm16(chunk)
                        self.wfile.write(f"{len(data):x}\r\n".encode())
                        self.wfile.write(data + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    wav = _wav_bytes(svc.synthesize(req), sr)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(wav)))
                    self.end_headers()
                    self.wfile.write(wav)
            elif self.path == "/batch":
                body = self._read_json()
                wavs = svc.batch(body.get("requests"))
                self._json(200, {
                    "sample_rate": sr,
                    "wavs_b64": [
                        base64.b64encode(_wav_bytes(y, sr)).decode()
                        for y in wavs
                    ],
                })
            else:
                self._json(404, {"error": f"no route {self.path}"})
        except TTSRequestError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # engine errors surface as 500, not a hang
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(cfg, synth, host: str = "127.0.0.1", port: int = 8080,
                verbose: bool = False,
                microbatch_window_ms: float = 5.0,
                device: str = "cuda") -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; caller runs ``serve_forever()``.
    Port 0 picks a free port (``server.server_address[1]``).
    ``microbatch_window_ms`` is the cross-request collection window for
    concurrent ``/synthesize`` requests (negative disables batching).
    ``device`` is where the Synthesizer must run ("cuda" unless the caller
    asks for the CPU)."""
    service = TTSService(
        cfg, synth, microbatch_window_ms=microbatch_window_ms, device=device
    )
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.service = service
    httpd.verbose = verbose
    return httpd
