"""Deterministic-schedule simulation of the RPC connection state machine.

Reference analog: specs/RDMASocket/ — the P-language model of the socket
state machine (connect/handshake/send/recv/teardown races).  Where the
reference checks an abstract model, this simulator drives the REAL
``t3fs_torch.net.conn.Connection`` on both ends of an in-memory byte pipe whose
delivery the scheduler fully controls: bytes move only when the schedule
pumps them, in chunk sizes the schedule picks, with optional mid-frame
cuts and single-byte corruption.  Every interleaving the scheduler
produces is one a real TCP socket could produce (arbitrary segmentation,
torn frames, resets), so invariant violations here are real protocol bugs.

Invariants checked after every schedule (``check_quiesced``):

  C1 no leaked waiters:   every issued call resolved (result OR error)
  C2 no leaked handlers:  the dispatcher task set drains once closed
  C3 clean close:         a cut/corrupt stream closes BOTH ends; pending
                          calls fail with RPC_SEND_FAILED, none hang
  C4 framing integrity:   under any segmentation, delivered frames decode
                          to exactly the bytes sent (no tears, no reorders)

The port of t3fs/testing/conn_sim.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field

from t3fs_torch.net.conn import Connection
from t3fs_torch.utils.status import StatusError


class SimWriter:
    """Just enough asyncio.StreamWriter for Connection: written bytes go
    to an outbox the SCHEDULER pumps into the peer's reader."""

    def __init__(self, name: str):
        self.name = name
        self.outbox = bytearray()
        self.closed = False
        self.peer_reader: asyncio.StreamReader | None = None

    def write(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("write after close")
        self.outbox += data

    async def drain(self) -> None:
        if self.closed:
            raise ConnectionResetError("drain after close")

    def close(self) -> None:
        self.closed = True
        # model FIN: the peer's read side sees EOF once our end closes
        if self.peer_reader is not None and \
                not getattr(self.peer_reader, "_sim_eof", False):
            self.peer_reader._sim_eof = True
            self.peer_reader.feed_eof()

    async def wait_closed(self) -> None:
        return

    def get_extra_info(self, key, default=None):
        return default


@dataclass
class SimLink:
    """One direction of the pipe: a's outbox -> b's reader."""
    writer: SimWriter
    reader: asyncio.StreamReader
    delivered: int = 0

    def pump(self, n: int) -> int:
        """Deliver up to n pending bytes; returns bytes moved."""
        chunk = bytes(self.writer.outbox[:n])
        if not chunk:
            return 0
        del self.writer.outbox[:n]
        if getattr(self.reader, "_sim_eof", False):
            return 0                       # receiver already saw FIN: drop
        self.reader.feed_data(chunk)
        self.delivered += len(chunk)
        return len(chunk)

    def corrupt_next(self) -> bool:
        """Flip one bit of the next undelivered byte (header or body)."""
        if not self.writer.outbox:
            return False
        self.writer.outbox[0] ^= 0x40
        return True

    def cut(self) -> None:
        """Drop everything in flight and EOF the receiver (TCP RST)."""
        self.writer.outbox.clear()
        self.writer.closed = True
        if not getattr(self.reader, "_sim_eof", False):
            self.reader._sim_eof = True
            self.reader.feed_eof()


class SimPair:
    """Two real Connections over two scheduled links (full duplex)."""

    def __init__(self, dispatcher_a=None, dispatcher_b=None,
                 compress_threshold: int = 0):
        ra, rb = asyncio.StreamReader(), asyncio.StreamReader()
        wa, wb = SimWriter("a->b"), SimWriter("b->a")
        wa.peer_reader, wb.peer_reader = rb, ra
        self.ab = SimLink(wa, rb)
        self.ba = SimLink(wb, ra)
        self.a = Connection(ra, wa, dispatcher_a, name="sim-a",
                            compress_threshold=compress_threshold)
        self.b = Connection(rb, wb, dispatcher_b, name="sim-b",
                            compress_threshold=compress_threshold)
        self.a.start()
        self.b.start()

    async def settle(self) -> None:
        """Let spawned tasks run until no link has pending bytes and the
        event loop is idle for a tick."""
        for _ in range(50):
            await asyncio.sleep(0)
        while self.ab.writer.outbox or self.ba.writer.outbox:
            self.ab.pump(1 << 20)
            self.ba.pump(1 << 20)
            for _ in range(50):
                await asyncio.sleep(0)

    async def close(self) -> None:
        await self.a.close()
        await self.b.close()
        for _ in range(20):
            await asyncio.sleep(0)

    def check_quiesced(self) -> None:
        for conn in (self.a, self.b):
            assert not conn._waiters, \
                f"{conn.name}: leaked waiters {list(conn._waiters)}"  # C1
            live = [t for t in conn._tasks if not t.done()
                    and t is not conn._loop_task]
            assert not live, f"{conn.name}: leaked handler tasks {live}"  # C2


async def run_schedule(seed: int, calls: int = 20, cut_after: int | None = None,
                       corrupt_after: int | None = None,
                       compress_threshold: int = 0) -> dict:
    """One schedule: issue `calls` concurrent echo calls in BOTH directions
    while pumping bytes in random-sized chunks; optionally cut or corrupt
    the a->b link after N pump steps.  Returns counters for assertions."""
    rng = random.Random(seed)

    async def echo(body, payload, conn):
        if rng.random() < 0.3:
            await asyncio.sleep(0)         # reschedule mid-handler
        return body, payload

    dispatcher = {"Sim.echo": echo}
    pair = SimPair(dict(dispatcher), dict(dispatcher),
                   compress_threshold=compress_threshold)

    async def one_call(conn, i):
        try:
            rsp, pay = await conn.call("Sim.echo", None,
                                       payload=bytes([i % 256]) * rng.randint(1, 4096),
                                       timeout=5.0)
            return ("ok", pay)
        except StatusError as e:
            return ("err", str(e.code))

    tasks = [asyncio.create_task(one_call(pair.a, i)) for i in range(calls)]
    tasks += [asyncio.create_task(one_call(pair.b, i)) for i in range(calls)]

    steps = 0
    cut_done = corrupt_done = False
    while any(not t.done() for t in tasks):
        steps += 1
        if corrupt_after is not None and steps >= corrupt_after \
                and not corrupt_done:
            corrupt_done = pair.ab.corrupt_next()
        if cut_after is not None and steps >= cut_after and not cut_done:
            pair.ab.cut()
            pair.ba.cut()
            cut_done = True
        link = pair.ab if rng.random() < 0.5 else pair.ba
        link.pump(rng.choice([1, 3, 7, 64, 1024, 1 << 20]))
        for _ in range(rng.randint(1, 8)):
            await asyncio.sleep(0)
        if steps > 100_000:
            raise AssertionError("schedule did not quiesce (hang)")  # C3
    # t3fslint: allow(blocking-in-async) — the quiesce loop above completed every worker task
    results = [t.result() for t in tasks]
    await pair.settle()
    await pair.close()
    pair.check_quiesced()
    bad_payloads = sum(
        1 for i, (s, p) in enumerate(results)
        if s == "ok" and p != bytes([i % calls % 256]) * len(p))
    return {
        "ok": sum(1 for s, _ in results if s == "ok"),
        "err": sum(1 for s, _ in results if s == "err"),
        # C4: without corruption this must be 0; WITH corruption at most
        # the one flipped frame may slip through (bulk payload integrity
        # is the app layer's end-to-end checksum, as in the reference) —
        # envelope bytes are wire-CRC'd and always fail closed
        "bad_payloads": bad_payloads,
        "payload_ok": bad_payloads == 0,
        "steps": steps,
    }
