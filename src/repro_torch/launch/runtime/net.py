"""Framed-TCP message node: the transport under the proc engine.

One `Node` per process: an asyncio event loop on a dedicated thread owns
every connection (server + dials); the compute thread talks to it through
thread-safe queues.  Each connection is drained by one sequential task,
so per-link frame order is preserved even under injected latency (the
delay is awaited inside that task -- a slow link serializes, it never
reorders).

Receive semantics (the straggler machinery of the whole runtime):

  * frames land in a per-kind inbox; `recv` filters by (src, step, tag)
    with a timeout/retry policy from NetConfig and raises NodeTimeout
    when the budget is gone -- a peer that never delivers *is* a
    straggler, no schedule required;
  * frames for FUTURE steps are buffered until their step comes up;
  * frames for PAST steps (a slow peer's late gradient block) are
    dropped on sight -- exactly the "ignore stale contributions"
    behavior of the paper's elastic decode;
  * an ERR frame from a peer aborts every pending recv (PeerFailure).

Every send is counted into `sent_bytes`/`sent_frames` by protocol phase;
the coordinator sums these across processes into
TrainResult.measured_comm.
"""

from __future__ import annotations

import asyncio
import collections
import json
import queue
import threading
import time

from . import wire
from .config import NetConfig

#: rank of the coordinator on the wire (fits the u16 src header field)
COORD = 0xFFFF

# frame kinds (wire header `kind`)
HELLO = 1     # connection handshake: registers the sender's rank
LISTEN = 2    # worker -> coord: my server address
SESSION = 3   # coord -> worker: config + state rows + address book
READY = 4     # worker -> coord: mesh connected
START = 5     # coord -> worker: barrier release, training begins
ENC = 6       # model-encode reduce-scatter partial rows
SHARE = 7     # gradient-share all-to-all block
OPEN = 8      # worker -> coord: share rows of a value to open
OPENED = 9    # coord -> worker: the reconstructed public value
RESULT = 10   # worker -> coord: final model share rows + stats
BYE = 11      # coord -> worker: result received, shut down
ERR = 12      # worker -> coord (or broadcast): fatal error report

KIND_NAMES = {HELLO: "HELLO", LISTEN: "LISTEN", SESSION: "SESSION",
              READY: "READY", START: "START", ENC: "ENC", SHARE: "SHARE",
              OPEN: "OPEN", OPENED: "OPENED", RESULT: "RESULT",
              BYE: "BYE", ERR: "ERR"}

# `tag` sub-channels of OPEN/OPENED
TAG_TRUNC = 0   # TruncPr's masked opening (every step)
TAG_HIST = 1    # per-step model opening (history runs)


class NodeTimeout(RuntimeError):
    """recv() exhausted its timeout x retries budget."""


class PeerFailure(RuntimeError):
    """A peer reported a fatal error or died mid-session."""


class Node:
    """One process's endpoint: server, dialed links, inboxes, counters."""

    def __init__(self, rank: int, cfg: NetConfig | None = None):
        self.rank = rank
        self.cfg = cfg or NetConfig()
        self.port = None
        self.sent_bytes: dict = {}
        self.sent_frames: dict = {}
        #: stale frames discarded by the drop-past-steps rule, keyed by
        #: kind name.  Receiver-side accounting only: the sender already
        #: counted these under sent_frames, so the per-phase sent totals
        #: stay timing-invariant (and equal to the static budget) no
        #: matter how many late frames get dropped here.
        self.dropped_frames: dict = {}
        #: optional out-of-band liveness probe, called between recv
        #: retries (the coordinator checks worker exit codes here)
        self.liveness = None
        self._loop = None
        self._thread = None
        self._server = None
        self._writers: dict = {}
        self._tasks: list = []
        self._inbox: dict = {}          # kind -> queue.Queue[Frame]
        self._pending: dict = {}        # kind -> deque[Frame]
        self._errors: list = []         # ERR frames / disconnect reports
        self._lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self, listen: bool = True):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name=f"node-{self.rank}")
        self._thread.start()
        if listen:
            fut = asyncio.run_coroutine_threadsafe(
                self._start_server(), self._loop)
            self.port = fut.result(timeout=10.0)
        return self

    def stop(self):
        if self._loop is None:
            return

        async def _shutdown():
            for w in list(self._writers.values()):
                try:
                    w.close()
                except Exception:  # noqa: BLE001 -- teardown best-effort
                    pass
            if self._server is not None:
                self._server.close()
            me = asyncio.current_task()
            for t in asyncio.all_tasks(self._loop):
                if t is not me:
                    t.cancel()
            await asyncio.sleep(0)      # let cancellations land
            self._loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
        self._thread.join(timeout=5.0)

    def configure(self, cfg: NetConfig):
        """Adopt the session NetConfig (workers learn it via SESSION)."""
        self.cfg = cfg

    # ----------------------------------------------------------- event loop

    async def _start_server(self):
        self._server = await asyncio.start_server(
            self._accept, host=self.cfg.host, port=0)
        return self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer):
        await self._pump(reader, writer, peer=None)

    async def _pump(self, reader, writer, peer):
        """Drain one connection sequentially: parse, delay, dispatch."""
        fr = wire.FrameReader()
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    fr.close()
                    break
                for frame in fr.feed(data):
                    if peer is None and frame.kind == HELLO:
                        peer = frame.src
                        self._writers[peer] = writer
                        continue
                    delay = self.cfg.delay(frame.src, self.rank,
                                           len(frame.payload))
                    if delay > 0:
                        await asyncio.sleep(delay)
                    self._dispatch(frame)
        except (asyncio.CancelledError, ConnectionError, OSError):
            pass
        except wire.WireError as e:
            self._errors.append(f"link from {peer}: {e}")
        finally:
            if peer is not None:
                self._writers.pop(peer, None)

    def _dispatch(self, frame):
        if frame.kind == ERR:
            # ERR payloads are UTF-8 JSON ({"rank": int, "error": str});
            # fall back to the raw text so a malformed report still
            # surfaces instead of masking the original failure.
            text = frame.payload.decode("utf-8", "replace")
            try:
                text = json.loads(text)["error"]
            except (ValueError, TypeError, KeyError):
                pass
            self._errors.append(f"peer {frame.src} failed: {text}")
            return
        self._queue(frame.kind).put(frame)

    def _queue(self, kind):
        with self._lock:
            if kind not in self._inbox:
                self._inbox[kind] = queue.Queue()
                self._pending[kind] = collections.deque()
            return self._inbox[kind]

    # ----------------------------------------------------------------- send

    def connect(self, dst: int, host: str, port: int):
        """Dial a peer, retrying until NetConfig.connect_timeout_s."""
        timeout = self.cfg.connect_timeout_s
        fut = asyncio.run_coroutine_threadsafe(
            self._connect(dst, host, port, timeout), self._loop)
        fut.result(timeout=timeout + 5.0)

    async def _connect(self, dst, host, port, timeout):
        deadline = time.monotonic() + timeout
        while True:
            try:
                reader, writer = await asyncio.open_connection(host, port)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                await asyncio.sleep(0.05)
        self._writers[dst] = writer
        hello = wire.encode_frame(HELLO, self.rank, 0, 0)
        self._count("setup", len(hello))
        writer.write(hello)
        self._tasks.append(
            self._loop.create_task(self._pump(reader, writer, dst)))

    def send(self, dst: int, kind: int, step: int = 0, tag: int = 0,
             payload: bytes = b"", phase: str = "setup"):
        """Queue one frame for dst; counted under `phase`, never blocks."""
        data = wire.encode_frame(kind, self.rank, tag, step, payload)
        self._count(phase, len(data))
        self._loop.call_soon_threadsafe(self._write, dst, data)

    def _count(self, phase, nbytes):
        self.sent_bytes[phase] = self.sent_bytes.get(phase, 0) + nbytes
        self.sent_frames[phase] = self.sent_frames.get(phase, 0) + 1

    def _write(self, dst, data):
        w = self._writers.get(dst)
        if w is None or w.is_closing():
            self._errors.append(f"no live link to peer {dst}")
            return
        w.write(data)

    # ----------------------------------------------------------------- recv

    def recv(self, kind: int, src: int | None = None,
             step: int | None = None, tag: int | None = None,
             timeout: float | None = None,
             retries: int | None = None) -> wire.Frame:
        """Blocking filtered receive with the NetConfig timeout policy."""
        timeout = self.cfg.recv_timeout_s if timeout is None else timeout
        retries = self.cfg.recv_retries if retries is None else retries

        def match(f):
            return ((src is None or f.src == src)
                    and (step is None or f.step == step)
                    and (tag is None or f.tag == tag))

        for _ in range(max(1, retries)):
            frame = self._wait(kind, match, timeout, drop_below=step)
            if frame is not None:
                return frame
            if self.liveness is not None:
                self.liveness()
        raise NodeTimeout(
            f"rank {self.rank}: no {KIND_NAMES.get(kind, kind)} frame "
            f"(src={src}, step={step}, tag={tag}) after "
            f"{max(1, retries)} x {timeout}s")

    def recv_any(self, kind: int, step: int,
                 timeout: float) -> wire.Frame | None:
        """First `kind` frame at exactly `step` from ANY peer, else None
        after `timeout` -- the decode phase's straggler-tolerant wait."""
        return self._wait(kind, lambda f: f.step == step, timeout,
                          drop_below=step)

    def _wait(self, kind, match, timeout, drop_below=None):
        q = self._queue(kind)
        pend = self._pending[kind]
        deadline = time.monotonic() + timeout
        while True:
            if drop_below is not None:
                for i in range(len(pend) - 1, -1, -1):
                    if pend[i].step < drop_below:
                        self._drop(kind)
                        del pend[i]
            for i, f in enumerate(pend):
                if match(f):
                    del pend[i]
                    return f
            self._raise_errors()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                f = q.get(timeout=min(0.05, remaining))
            except queue.Empty:
                continue
            if match(f):
                return f
            if drop_below is not None and f.step < drop_below:
                self._drop(kind)              # stale: a passed step's frame
                continue
            pend.append(f)

    def _drop(self, kind):
        name = KIND_NAMES.get(kind, str(kind))
        self.dropped_frames[name] = self.dropped_frames.get(name, 0) + 1

    def _raise_errors(self):
        if self._errors:
            raise PeerFailure("; ".join(str(e) for e in self._errors))

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {"bytes": dict(self.sent_bytes),
                "frames": dict(self.sent_frames),
                "dropped": dict(self.dropped_frames)}
