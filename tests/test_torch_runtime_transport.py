"""repro_torch.launch.runtime's wire, NetConfig and Node against the JAX
package's, on the CPU.

The same arrays and frames pack to the same bytes in both packages; a
frame stream reassembles from any chunking; malformed streams raise
WireError; the link model and its environment knobs agree; and a live
two-Node socket session keeps per-link order under injected latency,
times out, and drops (and counts) stale frames.  The cases mirror
tests/test_runtime_transport.py's.
"""

import time

import numpy as np
import pytest

from repro.launch.runtime import config as jconfig
from repro.launch.runtime import net as jnet
from repro.launch.runtime import wire as jwire
from repro_torch.launch.runtime import net, wire
from repro_torch.launch.runtime.config import NetConfig

#: payload sizes spanning the interesting boundaries: empty, sub-header,
#: around the 64KiB socket-read chunk, and well past it
SIZES = (0, 1, 15, 16, 17, 1024, (1 << 16) - 1, (1 << 16) + 7, (1 << 17) + 3)


def _payload(size: int, seed: int) -> bytes:
    if size == 0:
        return b""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def test_constants_and_frame_kinds_match_the_jax_package():
    for name in ("MAGIC", "VERSION", "HEADER_SIZE", "MAX_PAYLOAD"):
        assert getattr(wire, name) == getattr(jwire, name), name
    assert wire.HEADER.format == jwire.HEADER.format
    for name in ("COORD", "HELLO", "LISTEN", "SESSION", "READY", "START",
                 "ENC", "SHARE", "OPEN", "OPENED", "RESULT", "BYE", "ERR",
                 "TAG_TRUNC", "TAG_HIST"):
        assert getattr(net, name) == getattr(jnet, name), name
    assert net.KIND_NAMES == jnet.KIND_NAMES


# ---------------------------------------------------------------- frame codec

@pytest.mark.parametrize("size", SIZES)
def test_frame_round_trip_and_bytes_match_the_jax_package(size):
    seed = 7919 * size + 3
    payload = _payload(size, seed)
    kind = seed % 12 + 1
    src, tag, step = seed % 0x10000, (seed >> 4) % 0x10000, seed
    data = wire.encode_frame(kind, src, tag, step, payload)
    assert data == jwire.encode_frame(kind, src, tag, step, payload)
    frames = wire.FrameReader().feed(data)
    assert len(frames) == 1
    f = frames[0]
    assert (f.kind, f.src, f.tag, f.step) == (kind, src, tag, step)
    assert f.payload == payload
    assert len(f) == len(data) == wire.HEADER_SIZE + size


@pytest.mark.parametrize("chunk", [1, 7, 4096, 4099, 1 << 16])
def test_partial_read_reassembly(chunk):
    """Any stream chunking yields the same frames in the same order."""
    payloads = [_payload(sz, chunk + i)
                for i, sz in enumerate((0, 3, (1 << 16) + 1, 57))]
    stream = b"".join(wire.encode_frame(net.ENC, 2, 0, i, p)
                      for i, p in enumerate(payloads))
    fr = wire.FrameReader()
    got = []
    for off in range(0, len(stream), chunk):
        got.extend(fr.feed(stream[off:off + chunk]))
    fr.close()
    assert fr.pending == 0
    assert [f.step for f in got] == [0, 1, 2, 3]
    assert [f.payload for f in got] == payloads


def _truncated():
    data = wire.encode_frame(net.ENC, 0, 0, 0, b"x" * 100)
    fr = wire.FrameReader()
    assert fr.feed(data[:-1]) == []          # incomplete: nothing yet
    assert fr.pending == len(data) - 1
    fr.close()


def _bad_magic():
    wire.FrameReader().feed(
        b"XX" + wire.encode_frame(net.ENC, 0, 0, 0, b"hi")[2:])


def _unknown_version():
    data = bytearray(wire.encode_frame(net.ENC, 0, 0, 0))
    data[2] = wire.VERSION + 1
    wire.FrameReader().feed(bytes(data))


def _oversized_header():
    # a header claiming a length beyond the cap fails fast, before any
    # payload byte is buffered
    hdr = wire.HEADER.pack(wire.MAGIC, wire.VERSION, net.ENC, 0, 0, 0, 2048)
    wire.FrameReader(max_payload=1024).feed(hdr)


def _short_array():
    wire.unpack_array(wire.pack_array(
        np.arange(6, dtype=np.int32).reshape(2, 3))[:-2])


@pytest.mark.parametrize("bad,match", [
    (_truncated, "truncated"), (_bad_magic, "magic"),
    (_unknown_version, "version"), (_oversized_header, "exceeds"),
    (_short_array, "needs"), (lambda: wire.unpack_array(b""), "shorter")],
    ids=["truncated", "bad_magic", "unknown_version", "oversized",
         "short_array", "empty_array"])
def test_malformed_input_raises_wire_error(bad, match):
    with pytest.raises(wire.WireError, match=match):
        bad()


def test_oversized_payload_rejected_at_encode(monkeypatch):
    monkeypatch.setattr(wire, "MAX_PAYLOAD", 64)
    with pytest.raises(wire.WireError, match="exceeds"):
        wire.encode_frame(net.ENC, 0, 0, 0, b"\0" * 65)


# -------------------------------------------------------------- array payloads

@pytest.mark.parametrize("dtype,shape", [
    ("<i4", ()), ("<i4", (7,)), ("<i4", (4, 5)), ("<f4", (2, 3, 4)),
    ("<u1", (0,)), ("<i8", (1, 1, 1, 6)), ("<u4", (2,)),
    ("<f8", (3, 1, 2))])
def test_pack_array_round_trip_and_bytes_match_the_jax_package(dtype,
                                                                shape):
    rng = np.random.default_rng(len(shape))
    arr = rng.integers(0, 100, size=shape).astype(np.dtype(dtype))
    blob = wire.pack_array(arr)
    assert blob == jwire.pack_array(arr)
    assert wire.share_payload(arr) == blob == jwire.share_payload(arr)
    out = wire.unpack_array(blob)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)
    # a strided view packs as its C-order copy
    if arr.ndim >= 2:
        view = arr.swapaxes(0, -1)
        assert wire.pack_array(view) == jwire.pack_array(view)


def test_share_payload_takes_a_cpu_tensor():
    import torch
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert wire.share_payload(t) == jwire.pack_array(t.numpy())


# ------------------------------------------------------------------ NetConfig

LINKS = ((None, 2, 0.5), (1, 2, 0.2), (1, None, 0.3))


@pytest.mark.parametrize("src,dst,want", [
    (1, 2, 0.2),       # exact (src, dst) beats both wildcards
    (0, 2, 0.5),       # dst-only wildcard
    (1, 0, 0.3),       # src-only wildcard
    (0, 0, 0.01)])     # default
def test_link_latency_most_specific_wins(src, dst, want):
    cfg = NetConfig(latency_s=0.01, links=LINKS)
    ref = jconfig.NetConfig(latency_s=0.01, links=LINKS)
    assert cfg.link_latency(src, dst) == ref.link_latency(src, dst) == want


def test_bandwidth_adds_serialization_delay():
    cfg = NetConfig(latency_s=0.1, bandwidth_bps=1000.0)
    assert cfg.delay(0, 1, 500) == pytest.approx(0.6)
    assert cfg.delay(0, 1, 500) == jconfig.NetConfig(
        latency_s=0.1, bandwidth_bps=1000.0).delay(0, 1, 500)
    assert NetConfig().delay(0, 1, 10**9) == 0.0   # infinite by default


@pytest.mark.parametrize("env", [
    {}, {"REPRO_PROC_LATENCY_S": "0.25", "REPRO_PROC_TIMEOUT_S": "7",
         "REPRO_PROC_RETRIES": "2"},
    {"REPRO_PROC_HOST": "localhost"}])
def test_from_env_matches_the_jax_package(monkeypatch, env):
    for name in ("REPRO_PROC_HOST", "REPRO_PROC_LATENCY_S",
                 "REPRO_PROC_TIMEOUT_S", "REPRO_PROC_RETRIES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg, ref = NetConfig.from_env(), jconfig.NetConfig.from_env()
    assert [f.name for f in cfg.__dataclass_fields__.values()] == \
        [f.name for f in ref.__dataclass_fields__.values()]
    assert vars(cfg) == vars(ref)
    if env.get("REPRO_PROC_RETRIES"):
        assert (cfg.latency_s, cfg.recv_timeout_s, cfg.recv_retries) \
            == (0.25, 7.0, 2)


# ------------------------------------------------- live sockets: link ordering

def _pair(cfg):
    a = net.Node(0, cfg=cfg).start()
    b = net.Node(1, cfg=cfg).start(listen=False)
    b.connect(0, cfg.host, a.port)
    return a, b


def test_per_link_order_preserved_under_latency():
    """Frames on one link arrive in send order even when injected delays
    differ per frame (bandwidth makes big frames slower): the receiver
    drains each connection with ONE sequential task, so a slow link
    serializes, it never reorders."""
    payloads = [_payload(sz, i) for i, sz in
                enumerate(((1 << 16) + 5, 4096, 512, 64, 0))]
    a, b = _pair(NetConfig(latency_s=0.01, bandwidth_bps=4e6))
    try:
        for i, p in enumerate(payloads):
            b.send(0, net.ENC, step=i, payload=p, phase="encode")
        got = [a.recv(net.ENC, src=1, timeout=10.0)
               for _ in range(len(payloads))]
        assert [f.step for f in got] == list(range(len(payloads)))
        assert [f.payload for f in got] == payloads
        # every send was metered into the sender's phase counters
        assert b.sent_frames["encode"] == len(payloads)
        assert b.sent_bytes["encode"] == sum(
            wire.HEADER_SIZE + len(p) for p in payloads)
    finally:
        a.stop()
        b.stop()


def test_recv_timeout_raises_nodetimeout():
    a = net.Node(0, cfg=NetConfig(recv_timeout_s=0.05, recv_retries=2))
    a.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(net.NodeTimeout, match="no SHARE frame"):
            a.recv(net.SHARE, src=3, step=0)
        assert time.monotonic() - t0 >= 0.1        # 2 x 0.05 s
    finally:
        a.stop()


@pytest.mark.parametrize("how", ["recv", "recv_any"])
def test_stale_step_frames_are_dropped_and_counted(how):
    """A slow peer's frame for a PAST step never satisfies a later step's
    receive; each discard shows in the receiver's dropped_frames (by kind
    name), while the sender's per-phase sent counters keep every frame."""
    a, b = _pair(NetConfig(recv_timeout_s=0.2, recv_retries=1))
    try:
        b.send(0, net.SHARE, step=0, payload=b"late0", phase="exchange")
        b.send(0, net.SHARE, step=1, payload=b"late1", phase="exchange")
        b.send(0, net.SHARE, step=2, payload=b"fresh", phase="exchange")
        if how == "recv":
            got = a.recv(net.SHARE, src=1, step=2, timeout=5.0)
        else:
            deadline = time.monotonic() + 5.0
            got = None
            while got is None and time.monotonic() < deadline:
                got = a.recv_any(net.SHARE, 2, timeout=0.05)
        assert got is not None and got.payload == b"fresh"
        assert a.dropped_frames == {"SHARE": 2}
        assert a.stats()["dropped"] == {"SHARE": 2}
        assert b.dropped_frames == {}
        assert b.sent_frames["exchange"] == 3   # dropped frames still sent
        with pytest.raises(net.NodeTimeout):
            a.recv(net.SHARE, src=1, step=2, timeout=0.05, retries=1)
    finally:
        a.stop()
        b.stop()


def test_err_frame_raises_peer_failure():
    """An ERR frame from a peer aborts the pending receive with its
    report."""
    a, b = _pair(NetConfig(recv_timeout_s=1.0, recv_retries=1))
    try:
        b.send(0, net.ERR, payload=b'{"rank": 1, "error": "boom"}')
        with pytest.raises(net.PeerFailure, match="peer 1 failed: boom"):
            a.recv(net.SHARE, src=1, step=0, timeout=5.0)
    finally:
        a.stop()
        b.stop()
