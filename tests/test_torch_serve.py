"""The port's serving engine and HTTP layer (gdkvm_tpu_torch/serve.py), on
the CPU, with a narrow fp32 model.

The tests of tests/test_serve.py that need no mesh or quantization, held
against the port's own stream_video, and the engine serving an exported
artifact against the engine serving the model.  The
load-bearing check is exactness: masks served through the multi-stream
engine (idle-slot freezing, state carry, chunk splitting, bit-packing)
equal stream_video's per session.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.eval.streaming import stream_video
from gdkvm_tpu_torch.io.export import load_artifact, save_artifact
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
from gdkvm_tpu_torch.parallel.mesh import Mesh, make_mesh
from gdkvm_tpu_torch.serve import (_RESIZE_CACHE_MAX, BatchingEngine,
                                   EngineOverloaded, ServeClient, _Piece,
                                   make_server)
from test_torch_gdr_bwd import _NO_CALLS, _plain_launchers

torch.set_num_threads(1)

SIZE = 48
CHUNK = 4


def _model(gdr_impl="auto"):
    cfg = ModelConfig(num_classes=2, enc_channels=(8, 16, 24, 32),
                      num_heads=2, head_dim_k=8, head_dim_v=8,
                      kpff_channels=(16, 16), compute_dtype="float32",
                      gdr_impl=gdr_impl)
    return init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def small_model():
    return _model()


@pytest.fixture()
def engine(small_model):
    eng = BatchingEngine(model=small_model, streams=3, chunk=CHUNK,
                         image_size=SIZE)
    yield eng
    eng.close()


@pytest.fixture()
def server(engine):
    srv = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _video(seed, t=10):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (t, SIZE, SIZE, 1), np.uint8)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


def test_engine_matches_stream_video(small_model, engine):
    """Engine output ≡ direct chunked streaming, including a ragged tail."""
    video = _video(0, t=10)                     # 10 = 2×4 + ragged 2
    sid = engine.open_session()["session"]
    got = engine.infer(sid, video)
    np.testing.assert_array_equal(got, stream_video(small_model, video, chunk=CHUNK))


def test_engine_concurrent_sessions_exact(small_model, engine):
    """3 sessions in flight concurrently, each ≡ its own stream_video."""
    videos = [_video(i, t=8 + 2 * i) for i in range(3)]
    sids = [engine.open_session()["session"] for _ in range(3)]
    results = {}

    def run(i):
        results[i] = engine.infer(sids[i], videos[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(3):
        want = stream_video(small_model, videos[i], chunk=CHUNK)
        np.testing.assert_array_equal(results[i], want)


def test_idle_session_gc_reclaims_slot(small_model):
    """A crashed client must not keep its slot: with session_ttl set, an
    idle session is reclaimed by the batcher and the pool regains capacity;
    an active session within its TTL survives."""
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE, session_ttl=1.0)
    try:
        s1 = eng.open_session()
        eng.infer(s1["session"], _video(1, t=4))
        time.sleep(0.3)                          # active within its TTL
        assert eng.slot_of(s1["session"]) is not None
        assert eng.open_session() is None        # pool genuinely full
        _wait_for(lambda: eng.slot_of(s1["session"]) is None)
        assert eng.sessions_reclaimed == 1
        s2 = eng.open_session()
        assert s2 is not None, "reclaimed slot not reusable"
        # The recycled slot starts from a zero state (reset on open).
        video = _video(2, t=4)
        np.testing.assert_array_equal(eng.infer(s2["session"], video),
                                      stream_video(small_model, video, chunk=CHUNK))
        with pytest.raises(KeyError):            # a dead session fails cleanly
            eng.infer(s1["session"], video)
    finally:
        eng.close()


def test_infer_rejects_recycled_slot_mid_staging(small_model):
    """infer() resolves session → slot, then stages the video.  If the
    session is closed and its slot handed to a new client while staging,
    the stale request's pieces must not enter the new session's queue: the
    enqueue re-validates the session under the lock."""
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE)
    try:
        s1 = eng.open_session()["session"]
        staged, gate = threading.Event(), threading.Event()
        orig = eng._split

        def slow_split(v):            # block mid-staging, deterministically
            staged.set()
            assert gate.wait(timeout=30)
            return orig(v)

        eng._split = slow_split
        err = {}

        def run():
            try:
                eng.infer(s1, _video(1, t=2 * CHUNK))
            except KeyError as exc:
                err["e"] = exc

        th = threading.Thread(target=run)
        th.start()
        assert staged.wait(timeout=30)
        eng.close_session(s1)                 # closed mid-staging…
        s2 = eng.open_session()["session"]    # …and the slot recycled
        eng._split = orig
        gate.set()
        th.join(timeout=30)
        assert not th.is_alive()
        assert isinstance(err.get("e"), KeyError), err
        slot2 = eng.slot_of(s2)               # (outside the lock: not reentrant)
        with eng._lock:
            assert not eng._queues[slot2]     # new session unpolluted
    finally:
        eng.close()


def test_gc_close_rechecks_staleness_under_one_lock(small_model):
    """A session that becomes active between the GC's stale scan and the
    close is spared: _close_if_stale re-checks last activity and queue
    emptiness under one lock acquisition."""
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE, session_ttl=None)
    try:
        sid = eng.open_session()["session"]
        slot = eng.slot_of(sid)
        eng.session_ttl = 30.0
        # The scan said stale, then a request landed (one lock hold, so the
        # batcher cannot interleave).
        with eng._lock:
            eng._last_active[slot] = time.monotonic() - 60.0
            assert eng._stale_sids() == [sid]
            eng._last_active[slot] = time.monotonic()
        assert eng._close_if_stale(sid) is False
        assert eng.slot_of(sid) == slot
        # Stale by time but work queued: spared too.
        eng.pause()
        with eng._lock:
            eng._last_active[slot] = time.monotonic() - 60.0
            eng._queues[slot].append(_Piece(None, 0))
        assert eng._close_if_stale(sid) is False
        with eng._lock:
            eng._queues[slot].clear()
            eng._last_active[slot] = time.monotonic() - 60.0
        eng.resume()
        # Genuinely stale: closed, by this call or by the batcher's GC.
        eng._close_if_stale(sid)
        _wait_for(lambda: eng.slot_of(sid) is None)
    finally:
        eng.close()


def test_client_failed_connect_leaves_no_half_connection():
    """A failed connect() leaves no half-initialized connection behind: a
    later request on it would reconnect without TCP_NODELAY."""
    c = ServeClient("127.0.0.1", 1, timeout=0.5)   # nothing listens here
    with pytest.raises(OSError):
        c.health()
    assert c._c is None


def test_queue_stats_measure_real_waiting(small_model):
    """drain_stats(): pieces that queue report their wait and their depth at
    enqueue; an idle engine reports depth 0."""
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE)
    try:
        sid = eng.open_session()["session"]
        eng.infer(sid, _video(1, t=CHUNK))       # idle-engine request
        idle = eng.drain_stats()
        assert len(idle) == 1 and idle[0][2] == 0
        # Hold the batcher, enqueue 3 pieces, sleep, release: every piece
        # waited at least the hold time.
        eng.pause()
        done = {}
        th = threading.Thread(target=lambda: done.__setitem__(
            "m", eng.infer(sid, _video(2, t=3 * CHUNK))))
        th.start()

        def queued():
            with eng._lock:
                return len(eng._queues[0]) == 3
        _wait_for(queued)
        time.sleep(0.5)
        eng.resume()
        th.join(timeout=60)
        assert not th.is_alive() and done["m"].shape == (3 * CHUNK, SIZE, SIZE)
        stats = eng.drain_stats()
        assert len(stats) == 3
        assert sorted(s[2] for s in stats) == [0, 1, 2]
        assert min(s[0] for s in stats) >= 400
        assert all(s[1] > 0 for s in stats)
    finally:
        eng.close()


def test_engine_state_carry_across_infer_calls(small_model, engine):
    """Two infer() calls on one session ≡ one call over the whole video."""
    video = _video(42, t=8)
    sid = engine.open_session()["session"]
    part1 = engine.infer(sid, video[:4])
    part2 = engine.infer(sid, video[4:])
    np.testing.assert_array_equal(np.concatenate([part1, part2]),
                                  stream_video(small_model, video, chunk=CHUNK))


def test_engine_session_reset_on_reopen(engine):
    """A new session on a recycled slot starts from a zero state."""
    video = _video(7, t=4)
    s1 = engine.open_session()
    first = engine.infer(s1["session"], video)
    engine.infer(s1["session"], _video(8, t=4))   # advance the state
    assert engine.close_session(s1["session"])
    s2 = engine.open_session()
    np.testing.assert_array_equal(first, engine.infer(s2["session"], video))


def test_http_round_trip(small_model, engine, server):
    host, port = server.server_address
    c = ServeClient(host, port)
    info = c.health()
    assert info["ok"] and info["chunk"] == CHUNK and info["device"] == "cpu"
    c.open()
    video = _video(3, t=6)
    masks = c.infer(video)
    assert masks.shape == (6, SIZE, SIZE) and masks.dtype == np.uint8
    np.testing.assert_array_equal(masks, stream_video(small_model, video, chunk=CHUNK))
    c.close()
    gone = ServeClient(host, port)
    gone.session = "deadbeef0000"
    with pytest.raises(RuntimeError, match="unknown session"):
        gone.infer(video)
    gone.close()


def test_http_slot_exhaustion(engine, server):
    host, port = server.server_address
    clients = []
    for _ in range(engine.streams):
        c = ServeClient(host, port)
        c.open()
        clients.append(c)
    extra = ServeClient(host, port)
    with pytest.raises(RuntimeError, match="busy"):
        extra.open()
    clients[0].close()
    extra.open()           # the freed slot is reusable
    extra.close()
    for c in clients[1:]:
        c.close()


def test_engine_arbitrary_resolution_input(small_model, engine):
    """A native-resolution video is resized on the device to the engine
    size; masks come back at the engine size, equal to stream_video on the
    resized frames."""
    from gdkvm_tpu_torch.ops.preproc import resize_u8
    video = np.random.default_rng(9).integers(0, 255, (6, 100, 140, 1), np.uint8)
    sid = engine.open_session()["session"]
    masks = engine.infer(sid, video)
    assert masks.shape == (6, SIZE, SIZE) and masks.dtype == np.uint8
    resized = resize_u8(torch.from_numpy(video), (SIZE, SIZE)).numpy()
    np.testing.assert_array_equal(masks, stream_video(small_model, resized, chunk=CHUNK))


def test_close_session_fails_pending_pieces(small_model):
    """Closing a session with queued work unblocks a waiting infer() with a
    KeyError, deterministically: the batcher is paused so the queued pieces
    cannot drain before the close lands."""
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE)
    try:
        sid = eng.open_session()["session"]
        done = {}
        eng.pause()

        def run():
            try:
                eng.infer(sid, _video(1, t=40))   # 10 pieces queued
            except KeyError as exc:
                done["err"] = exc

        t = threading.Thread(target=run)
        t.start()

        def queued():
            with eng._lock:
                return bool(eng._queues.get(0))
        _wait_for(queued)
        eng.close_session(sid)
        eng.resume()
        t.join(timeout=30)
        assert not t.is_alive()
        assert isinstance(done.get("err"), KeyError)
    finally:
        eng.close()


def test_engine_pack_unpack_round_trip(engine):
    """Device bit-pack → host unpack is exact for every class count."""
    bits_before = engine._pack_bits
    try:
        for k in (2, 3, 4, 7, 16):
            engine._pack_bits = 1 if k <= 2 else 2 if k <= 4 else 4
            rng = np.random.default_rng(k)
            masks = rng.integers(0, k, (3, CHUNK, SIZE, SIZE)).astype(np.uint8)
            packed = engine._post(torch.from_numpy(masks),
                                  torch.tensor([0, 2])).numpy()
            assert packed.shape[-1] == SIZE * engine._pack_bits // 8
            np.testing.assert_array_equal(engine._unpack(packed), masks[[0, 2]])
    finally:
        engine._pack_bits = bits_before


def test_engine_overload_raises(small_model):
    """Beyond the in-flight byte budget, infer raises EngineOverloaded
    instead of queueing without bound."""
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE, max_inflight_mb=0.01)   # 10 KB
    try:
        sid = eng.open_session()["session"]
        eng.pause()
        with pytest.raises(EngineOverloaded):
            eng.infer(sid, _video(1, t=40))      # 40×48×48 ≈ 92 KB
        eng.resume()
        assert eng.infer(sid, _video(1, t=2)).shape == (2, SIZE, SIZE)
    finally:
        eng.close()


def test_http_overload_429(small_model):
    eng = BatchingEngine(model=small_model, streams=1, chunk=CHUNK,
                         image_size=SIZE, max_inflight_mb=0.01)
    srv = make_server(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address
        c = ServeClient(host, port)
        c.open()
        eng.pause()
        with pytest.raises(RuntimeError, match="budget"):
            c.infer(_video(2, t=40))
        eng.resume()
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def test_client_timeout_raises_cleanly():
    """A stalled server surfaces as TimeoutError, not a hang.  A bare
    listening socket that never answers stands in for a stalled tick."""
    import socket
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        host, port = srv.getsockname()
        c = ServeClient(host, port, timeout=0.5)
        c.session = "deadbeef0000"
        with pytest.raises(TimeoutError, match="did not answer"):
            c.infer(np.zeros((2, SIZE, SIZE, 1), np.uint8))
    finally:
        srv.close()


def test_resize_cache_capped(engine):
    """Distinct source resolutions beyond the LRU cap evict the oldest
    resize matrices instead of growing without bound."""
    rng = np.random.default_rng(0)
    sid = engine.open_session()["session"]
    for i in range(_RESIZE_CACHE_MAX + 3):
        video = rng.integers(0, 255, (2, 50 + 2 * i, 60, 1), np.uint8)
        assert engine.infer(sid, video).shape == (2, SIZE, SIZE)
    assert len(engine._resize_cache) == _RESIZE_CACHE_MAX
    assert ("resize", (50 + 2 * (_RESIZE_CACHE_MAX + 2), 60)) in engine._resize_cache
    assert ("resize", (50, 60)) not in engine._resize_cache


# ------------------------------------------------------------ port only


@pytest.mark.parametrize("fwd", ["monolith", "chain"])
def test_engine_threads_take_the_residual_free_kernel(fwd):
    """Grad mode is thread-local: the batcher thread enters inference mode
    itself, so a model whose parameters require grad takes one
    residual-free forward launch per tick (launchers swapped for their plain
    versions), in either forward split, and serves stream_video's masks."""
    model = _model(gdr_impl="pallas")
    assert all(p.requires_grad for p in model.parameters())
    video = _video(11, t=10)
    with _plain_launchers("stored", fwd=fwd) as pl:
        eng = BatchingEngine(model=model, streams=2, chunk=CHUNK, image_size=SIZE)
        try:
            ticks0 = eng.ticks
            sid = eng.open_session()["session"]
            got = eng.infer(sid, video)
            ticks = eng.ticks - ticks0
        finally:
            eng.close()
        want = stream_video(model, video, chunk=CHUNK)
    np.testing.assert_array_equal(got, want)
    key = "chain" if fwd == "chain" else "fwd"
    # warm-up tick + the session's ticks + stream_video's 3 chunks
    assert ticks == 3
    assert pl.calls == dict(_NO_CALLS, **{key: 1 + ticks + 3})


def test_unported_serving_options_raise(small_model):
    """A mesh with a model axis serves: a 1x2 mesh of the CPU (the heads
    split over its two places) gives stream_video's masks on ≥ 99.9% of the
    pixels; a mesh over a process group, a mesh with an artifact, or a
    pool that does not split over the mesh raises as in the JAX package."""
    cpu = torch.device("cpu")
    video = _video(45, t=6)
    eng = BatchingEngine(model=small_model, streams=2, chunk=CHUNK, image_size=SIZE,
                         mesh=make_mesh(data=1, model=2, devices=[cpu] * 2))
    try:
        assert len(eng._groups[0].mem) == 2
        got = eng.infer(eng.open_session()["session"], video)
    finally:
        eng.close()
    assert (got == stream_video(small_model, video, chunk=CHUNK)).mean() >= 0.999
    with pytest.raises(ValueError, match="drives every device from one process"):
        BatchingEngine(model=small_model, mesh=Mesh(data=1, devices=(cpu,), model=2),
                       warmup=False)
    with pytest.raises(ValueError, match="requires the model path"):
        BatchingEngine(artifact="art/", mesh=make_mesh(data=2, devices=[cpu] * 2),
                       warmup=False)
    with pytest.raises(ValueError, match="streams=3 must be divisible"):
        BatchingEngine(model=small_model, streams=3, mesh=make_mesh(data=2, devices=[cpu] * 2),
                       warmup=False)


def test_mesh_engine_matches_one_device_engine_and_stream_video(small_model):
    """The slot pool split over a data=2 mesh (a replica of the model on the
    second device) serves each session exactly as the one-device engine and
    stream_video do, with sessions in both groups at once, one resized on
    its group's device; /healthz reports the mesh."""
    mesh = make_mesh(data=2, devices=["cpu", "cpu:0"])
    videos = [_video(40 + i, t=9) for i in range(3)] + [
        np.random.default_rng(44).integers(0, 255, (6, 40, 56, 1), np.uint8)]
    engines = [BatchingEngine(model=small_model, streams=4, chunk=CHUNK, image_size=SIZE,
                              mesh=m) for m in (mesh, None)]
    srv = make_server(engines[0], "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert ServeClient(*srv.server_address).health()["mesh"] == {"data": 2, "model": 1}
        assert [g.lo for g in engines[0]._groups] == [0, 2]
        assert engines[0]._groups[1].raw_step is not engines[0]._groups[0].raw_step
        got = [dict() for _ in engines]
        for eng, out in zip(engines, got):
            sids = [eng.open_session()["session"] for _ in videos]
            threads = [threading.Thread(target=lambda i=i, sid=sid: out.__setitem__(
                i, eng.infer(sid, videos[i]))) for i, sid in enumerate(sids)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        for eng in engines:
            eng.close()
    for i, video in enumerate(videos):
        np.testing.assert_array_equal(got[0][i], got[1][i])
        if video.shape[1:3] == (SIZE, SIZE):
            np.testing.assert_array_equal(got[0][i], stream_video(small_model, video,
                                                                   chunk=CHUNK))


@pytest.fixture(scope="module")
def artifact(small_model, tmp_path_factory):
    """small_model exported for 3 slots of CHUNK frames at SIZE, loaded."""
    art = str(tmp_path_factory.mktemp("art") / "art")
    save_artifact(art, small_model, image_size=SIZE, chunk=CHUNK, batch=3)
    return load_artifact(art)


def test_artifact_engine_matches_model_engine(small_model, engine, artifact):
    """An engine serving the exported artifact gives the model engine's
    masks for every session (ragged tails, a resized session), takes its
    size and classes from meta.json and runs on the artifact's device."""
    eng = BatchingEngine(artifact=artifact, streams=3, chunk=CHUNK, image_size=7)
    try:
        assert (eng.image_size, eng.num_classes, eng.device) == (SIZE, 2, torch.device("cpu"))
        videos = [_video(20, t=10), _video(21, t=5),
                  np.random.default_rng(22).integers(0, 255, (6, 40, 56, 1), np.uint8)]
        for vid in videos:
            got = eng.infer(eng.open_session()["session"], vid)
            want = engine.infer(engine.open_session()["session"], vid)
            np.testing.assert_array_equal(got, want)
    finally:
        eng.close()


@pytest.mark.parametrize("streams,chunk", [(2, CHUNK), (3, CHUNK + 1)])
def test_artifact_engine_refuses_another_batch_or_chunk(artifact, streams, chunk):
    with pytest.raises(ValueError, match="artifact was exported for batch=3 chunk=4"):
        BatchingEngine(artifact=artifact, streams=streams, chunk=chunk, warmup=False)


def test_infer_rejects_bad_frames(engine):
    sid = engine.open_session()["session"]
    with pytest.raises(ValueError, match="frames must be"):
        engine.infer(sid, np.zeros((0, SIZE, SIZE, 1), np.uint8))
    with pytest.raises(ValueError, match="frames must be"):
        engine.infer(sid, np.zeros((2, SIZE, SIZE, 3), np.uint8))
