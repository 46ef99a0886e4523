"""App-layer tests: OpenAI-compatible server, demo server, CLI — driven over
real HTTP sockets / argv with the tiny model."""
import json
import threading
import urllib.request

import numpy as np
import pytest


@pytest.fixture(scope="module")
def oai_server(tiny_tts, tmp_path_factory):
    from qwen3tts_tpu.apps.openai_server import VoiceRegistry, serve
    from qwen3tts_tpu.audio.wav import write_wav

    d = tmp_path_factory.mktemp("oai")
    sr = 24_000
    wav = (0.3 * np.sin(np.linspace(0, 400, sr))).astype(np.float32)
    write_wav(d / "v.wav", wav, sr)
    reg = VoiceRegistry.from_args(None, str(d / "v.wav"), "ref")
    httpd = serve(tiny_tts, reg, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def _post(url, body, timeout=300):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def test_health(oai_server):
    with urllib.request.urlopen(oai_server + "/health") as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["default_voice"] == "default"


@pytest.mark.slow
def test_speech_wav_streaming(oai_server):
    with _post(oai_server + "/v1/audio/speech",
               {"input": "Hello.", "response_format": "wav"}) as r:
        data = r.read()
    assert r.headers["Content-Type"] == "audio/wav"
    assert data[:4] == b"RIFF" and data[4:8] == b"\xff\xff\xff\xff"
    pcm = np.frombuffer(data[44:], "<i2")
    assert len(pcm) > 0 and len(pcm) % 2000 == 0  # whole codec frames


@pytest.mark.slow
def test_speech_pcm(oai_server):
    with _post(oai_server + "/v1/audio/speech",
               {"input": "Hi.", "response_format": "pcm"}) as r:
        data = r.read()
    assert len(data) % 2 == 0 and len(data) > 0


def test_speech_errors(oai_server):
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/v1/audio/speech", {"voice": "x"})
    assert e.value.code == 400  # missing input
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/v1/audio/speech",
              {"input": "x", "response_format": "flac"})
    assert e.value.code == 400  # unsupported format
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(oai_server + "/v1/audio/speech",
              {"input": "x" * 5000})
    assert e.value.code == 400  # too long


@pytest.mark.slow
def test_speech_mp3_streaming(oai_server):
    from qwen3tts_tpu.audio import mp3

    if not mp3.is_available():
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(oai_server + "/v1/audio/speech",
                  {"input": "x", "response_format": "mp3"})
        assert e.value.code == 501  # graceful degradation
        return
    with _post(oai_server + "/v1/audio/speech",
               {"input": "Hello.", "response_format": "mp3"}) as r:
        data = r.read()
    assert r.headers["Content-Type"] == "audio/mpeg"
    assert len(data) > 200
    if mp3.decode_available():
        dec, sr = mp3.decode_mp3(data)
        assert sr == 24_000 and len(dec) > 0


@pytest.fixture(scope="module")
def oai_server_batched(tiny_tts, tmp_path_factory):
    from qwen3tts_tpu.apps.openai_server import VoiceRegistry, serve
    from qwen3tts_tpu.audio.wav import write_wav

    d = tmp_path_factory.mktemp("oai_cb")
    sr = 24_000
    wav = (0.3 * np.sin(np.linspace(0, 400, sr))).astype(np.float32)
    write_wav(d / "v.wav", wav, sr)
    reg = VoiceRegistry.from_args(None, str(d / "v.wav"), "ref")
    httpd = serve(tiny_tts, reg, host="127.0.0.1", port=0, max_batch=2)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", httpd.tts_state
    httpd.shutdown()
    httpd.tts_state.batcher.close()


@pytest.mark.slow
def test_concurrent_requests_share_batched_engine(oai_server_batched):
    url, state = oai_server_batched
    results = {}

    def fetch(i):
        with _post(url + "/v1/audio/speech",
                   {"input": f"Concurrent request {i}.", "response_format": "pcm",
                    "max_new_tokens": 24}) as r:
            results[i] = r.read()

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert sorted(results) == [0, 1, 2]
    for i, data in results.items():
        assert len(data) > 0 and len(data) % 2 == 0, f"req {i}"
    assert state.batcher.stats["served"] == 3


def test_health_exposes_scheduler_stats(oai_server_batched):
    url, state = oai_server_batched
    with urllib.request.urlopen(url + "/health") as r:
        body = json.loads(r.read())
    sched = body["scheduler"]
    for key in ("served", "joined_mid_batch", "batches", "cancelled",
                "active_rows", "queue_depth"):
        assert key in sched, key


@pytest.fixture(scope="module")
def oai_server_replicas(tiny_tts, tmp_path_factory):
    """--replicas mode: one model copy + continuous batcher per device
    behind least-loaded routing (runtime/replicas.ReplicaPool)."""
    from qwen3tts_tpu.apps.openai_server import VoiceRegistry, serve
    from qwen3tts_tpu.audio.wav import write_wav

    d = tmp_path_factory.mktemp("oai_rep")
    sr = 24_000
    wav = (0.3 * np.sin(np.linspace(0, 400, sr))).astype(np.float32)
    write_wav(d / "v.wav", wav, sr)
    reg = VoiceRegistry.from_args(None, str(d / "v.wav"), "ref")
    httpd = serve(tiny_tts, reg, host="127.0.0.1", port=0, max_batch=2,
                  replicas=2)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", httpd.tts_state
    httpd.shutdown()
    httpd.tts_state.batcher.close()


@pytest.mark.slow
def test_concurrent_requests_spread_over_replicas(oai_server_replicas):
    url, state = oai_server_replicas
    results = {}

    def fetch(i):
        with _post(url + "/v1/audio/speech",
                   {"input": f"Replica request {i}.", "response_format": "wav",
                    "max_new_tokens": 24}) as r:
            results[i] = r.read()

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert sorted(results) == [0, 1, 2, 3]
    for i, data in results.items():
        assert data[:4] == b"RIFF", f"req {i}"
    st = state.batcher.stats
    assert st["served"] == 4
    # /health surfaces per-replica occupancy incl. liveness
    with urllib.request.urlopen(url + "/health") as r:
        body = json.loads(r.read())
    reps = body["scheduler"]["replicas"]
    assert len(reps) == 2
    assert sum(r["served"] for r in reps) == 4
    assert all(r["alive"] for r in reps)


def test_client_disconnect_cancels_batched_row(tiny_tts, ref_wav, tmp_path):
    """A client that disconnects mid-stream must have its
    batch row cancelled — not keep generating to max_new_tokens and stall the
    shared batch once its queue fills."""
    import socket
    import time
    from http.server import ThreadingHTTPServer

    from qwen3tts_tpu.apps.openai_server import (TTSState, VoiceRegistry,
                                                 make_handler)
    from qwen3tts_tpu.runtime.engine import GenerationPolicy
    from qwen3tts_tpu.runtime.scheduler import ContinuousBatcher

    # EOS suppressed so the request can only end via budget — or the cancel
    batcher = ContinuousBatcher(
        tiny_tts, max_batch=2, chunk_size=4, max_new_tokens=2000,
        policy=GenerationPolicy(do_sample=False, min_new_tokens=10_000))
    reg = VoiceRegistry.from_args(None, ref_wav, "ref")
    state = TTSState(tiny_tts, reg, 4, batcher=batcher)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({"input": "An endless stream to abandon.",
                           "response_format": "pcm"}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(
            b"POST /v1/audio/speech HTTP/1.1\r\nHost: t\r\n"
            b"Content-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        assert s.recv(4096)  # headers + first audio bytes are flowing
        s.close()  # abandon the stream

        deadline = time.time() + 180
        while time.time() < deadline and batcher.stats["cancelled"] < 1:
            time.sleep(0.2)
        assert batcher.stats["cancelled"] == 1, (
            "disconnect did not cancel the batch row")
        # the batcher is healthy afterwards: row freed, next request served
        h = batcher.submit("After the disconnect.", "English", ref_wav, "ref",
                           max_new_tokens=8)
        wav = np.concatenate([a for a, _, _ in h.chunks()])
        assert len(wav) == 8 * tiny_tts.vocoder.spf
    finally:
        httpd.shutdown()
        batcher.close()


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_server(monkeypatch_module=None):
    import qwen3tts_tpu.apps.demo_server as ds

    httpd, state = ds.serve(models=["random:tiny"], dtype="fp32",
                            host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", state
    httpd.shutdown()


def test_demo_index_and_status(demo_server):
    url, _ = demo_server
    with urllib.request.urlopen(url + "/") as r:
        html = r.read().decode()
    assert "Qwen3-TTS" in html and "generate" in html
    with urllib.request.urlopen(url + "/status") as r:
        st = json.loads(r.read())
    assert st["available_models"] == ["random:tiny"]
    assert "speakers" in st and st["queue_depth"] == 0


@pytest.mark.slow
def test_demo_generate_stream_sse(demo_server, ref_wav):
    import base64

    url, _ = demo_server
    ref_b64 = base64.b64encode(open(ref_wav, "rb").read()).decode()
    with _post(url + "/generate/stream",
               {"mode": "clone", "text": "Hi.", "ref_audio_b64": ref_b64,
                "max_new_tokens": 8, "chunk_size": 4}) as r:
        raw = r.read().decode()
    events = [json.loads(line[6:]) for line in raw.split("\n\n")
              if line.startswith("data: ")]
    kinds = [e["event"] for e in events]
    assert "chunk" in kinds and kinds[-1] == "done"
    first = next(e for e in events if e["event"] == "chunk")
    assert first["ttfa_ms"] > 0 and "wav_b64" in first


def test_demo_guards(demo_server):
    import urllib.error

    url, _ = demo_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/generate", {"text": "x" * 2000})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/load", {"model": "nope"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/transcribe", {})
    assert e.value.code == 501  # ASR hook not registered


def test_demo_model_cache_lru(demo_server):
    _, state = demo_server
    state.get_model("random:tiny")
    assert list(state.model_cache) == ["random:tiny"]


# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_cli_clone_and_list_speakers(tmp_path, ref_wav, capsys):
    from qwen3tts_tpu.apps.cli import main

    out = tmp_path / "o.wav"
    main(["clone", "--model", "random:tiny", "--text", "Hello.",
          "--ref-audio", ref_wav, "--max-new-tokens", "6",
          "-o", str(out)])
    assert out.exists()
    from qwen3tts_tpu.audio.wav import read_wav
    wav, sr = read_wav(out)
    assert sr == 24_000 and len(wav) % 2000 == 0

    main(["custom", "--model", "random:tiny-custom", "--list-speakers"])
    outtxt = capsys.readouterr().out
    assert "vivian" in outtxt
