"""Native socket transport: the io_uring frame pump behind Connection.

The port's copy of t3fs/net/native_conn.py.  The reference's bulk plane
batches work-requests onto the NIC (src/common/net/ib/IBSocket.h:81-180)
instead of paying per-message syscalls.  Here ONE io_uring
(t3fs_torch/csrc/net_pump.cpp, built into the host library by
ops/_build.py) drives RECV/SEND for every connection in the process; the
pump thread parses t3f2 frames and verifies BOTH CRCs in C++, and the
asyncio loop is woken once per batch of completed frames through an
eventfd.  Python keeps serde, dispatch, and compression; it no longer
pays per-frame readexactly/header/CRC work or a send syscall per frame.

Opt-in per process with T3FS_NATIVE_NET=1 (checked per connection, so
tests can flip it) — the asyncio StreamReader/Writer transport stays the
default and the two interoperate byte-for-byte (same wire format).
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import socket
import weakref

from t3fs_torch.net.conn import Connection
from t3fs_torch.net.wire import FLAG_COMPRESS
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.net.native")

# pump_send backpressure: mirror asyncio drain()'s role — a frame is
# queued instantly, but a writer far ahead of the wire briefly yields
TX_HIGH_WATER = 32 << 20

# zero-copy threshold: payloads at or above ride the pump without a
# staging copy (TX: borrowed span pinned until the pump's tx-release
# event; RX: memoryview over the pump's pooled buffer).  Below it the
# copy is cheaper than the extra SEND completion / finalizer machinery.
ZC_MIN = int(os.environ.get("T3FS_NET_ZC_MIN", str(8192)))


def native_enabled() -> bool:
    return os.environ.get("T3FS_NATIVE_NET") == "1"


class _Py_buffer(ctypes.Structure):
    # CPython's Py_buffer (stable since 3.x); only .buf/.obj/.len matter here
    _fields_ = [("buf", ctypes.c_void_p), ("obj", ctypes.py_object),
                ("len", ctypes.c_ssize_t), ("itemsize", ctypes.c_ssize_t),
                ("readonly", ctypes.c_int), ("ndim", ctypes.c_int),
                ("format", ctypes.c_char_p), ("shape", ctypes.c_void_p),
                ("strides", ctypes.c_void_p), ("suboffsets", ctypes.c_void_p),
                ("internal", ctypes.c_void_p)]


class _BufferPin:
    """PyObject_GetBuffer pin on any buffer (readonly included): holds the
    exporter alive and its address stable until this object is dropped —
    how the pump borrows READONLY memoryview slices (the batched one-sided
    plane's scatter/gather parts) without a staging copy, which ctypes
    from_buffer refuses for readonly exporters."""

    __slots__ = ("_pb", "ptr")

    def __init__(self, obj):
        self._pb = _Py_buffer()
        if ctypes.pythonapi.PyObject_GetBuffer(
                ctypes.py_object(obj), ctypes.byref(self._pb), 0) != 0:
            ctypes.pythonapi.PyErr_Clear()
            raise BufferError("PyObject_GetBuffer failed")
        self.ptr = self._pb.buf

    def __del__(self):
        try:
            ctypes.pythonapi.PyBuffer_Release(ctypes.byref(self._pb))
        except Exception:
            pass


def _payload_ptr(buf):
    """(pointer, keepalive) for a bytes-like payload WITHOUT copying.
    bytes pin directly; writable buffers (bytearray, mutable memoryview
    — the BufferPool/RemoteBuf path) pin through a ctypes view; readonly
    views (batched scatter/gather slices over an RX frame or an engine
    read) pin through the buffer protocol, with one copy as last resort."""
    if isinstance(buf, bytes):
        return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p), buf
    mv = memoryview(buf)
    if mv.readonly:
        try:
            pin = _BufferPin(mv)
            return ctypes.c_void_p(pin.ptr), (pin, mv)
        except BufferError:
            b = bytes(mv)
            return ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p), b
    arr = (ctypes.c_ubyte * mv.nbytes).from_buffer(mv)
    # keep BOTH: the ctypes view (address) and the exporting buffer
    return ctypes.cast(arr, ctypes.c_void_p), (arr, buf)


class _PumpEvt(ctypes.Structure):
    _fields_ = [("data", ctypes.c_uint64),
                ("conn_id", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("msg_len", ctypes.c_uint32),
                ("payload_len", ctypes.c_uint32),
                ("kind", ctypes.c_int32),
                ("_pad", ctypes.c_int32)]


class NativePump:
    """One io_uring frame pump per (process, event loop)."""

    _per_loop: dict[int, "NativePump"] = {}

    @classmethod
    def get(cls) -> "NativePump":
        loop = asyncio.get_running_loop()
        pump = cls._per_loop.get(id(loop))
        if pump is None or pump.loop is not loop:
            # evict pumps whose loops are gone (each asyncio.run leaves
            # one behind otherwise: an io_uring, an eventfd, and a
            # parked thread per dead loop)
            for key, old in list(cls._per_loop.items()):
                if old.loop.is_closed() or old.loop is loop:
                    old.destroy()
                    cls._per_loop.pop(key, None)
            pump = cls(loop)
            cls._per_loop[id(loop)] = pump
        return pump

    def __init__(self, loop: asyncio.AbstractEventLoop):
        from t3fs_torch.ops._build import host_library
        lib = host_library()
        lib.t3fs_pump_create.restype = ctypes.c_void_p
        lib.t3fs_pump_create.argtypes = [ctypes.c_uint]
        lib.t3fs_pump_eventfd.restype = ctypes.c_int
        lib.t3fs_pump_eventfd.argtypes = [ctypes.c_void_p]
        lib.t3fs_pump_add.restype = ctypes.c_int64
        lib.t3fs_pump_add.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.t3fs_pump_send.restype = ctypes.c_int64
        lib.t3fs_pump_send.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_char_p, ctypes.c_uint64]
        lib.t3fs_pump_tx_depth.restype = ctypes.c_int64
        lib.t3fs_pump_tx_depth.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.t3fs_pump_poll.restype = ctypes.c_int
        lib.t3fs_pump_poll.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(_PumpEvt),
                                       ctypes.c_uint]
        lib.t3fs_pump_free.argtypes = [ctypes.c_uint64]
        lib.t3fs_pump_free2.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_uint64]
        lib.t3fs_pump_send2.restype = ctypes.c_int64
        lib.t3fs_pump_send2.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint64]
        lib.t3fs_pump_stats.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64 * 4)]
        lib.t3fs_pump_close.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.t3fs_pump_destroy.argtypes = [ctypes.c_void_p]
        self.lib = lib
        self.h = lib.t3fs_pump_create(1024)
        if not self.h:
            raise OSError("t3fs_pump_create failed (io_uring unavailable?)")
        self.efd = lib.t3fs_pump_eventfd(self.h)
        self.loop = loop
        self.conns: dict[int, "NativeConnection"] = {}
        # (conn_id, token) -> payload keepalive for in-flight zero-copy
        # sends; dropped on the pump's tx-release event, which fires
        # exactly when the kernel can no longer touch the bytes (entry
        # fully sent, or its conn reaped with no armed SQE)
        self._tx_pins: dict[tuple[int, int], object] = {}
        self._next_token = 1
        self._evts = (_PumpEvt * 256)()
        loop.add_reader(self.efd, self._drain)
        import atexit
        atexit.register(self.destroy)

    def attach(self, conn: "NativeConnection") -> int:
        # the pump owns a DUP of the fd; the Python socket object stays
        # with the connection (closed on conn.close())
        fd = os.dup(conn.sock.fileno())
        cid = self.lib.t3fs_pump_add(self.h, fd)
        if cid < 0:
            raise make_error(StatusCode.RPC_CONNECT_FAILED,
                             f"pump_add: errno {-cid}")
        self.conns[cid] = conn
        return int(cid)

    def send(self, conn_id: int, frame: bytes) -> int:
        depth = self.lib.t3fs_pump_send(self.h, conn_id, frame, len(frame))
        if depth < 0:
            raise make_error(StatusCode.RPC_SEND_FAILED,
                             f"pump_send: errno {-depth}")
        return int(depth)

    def send_zc(self, conn_id: int, hdr: bytes, payload) -> int:
        """Zero-copy send: only `hdr` (header+msg, small) is staged into
        the pump; `payload` is pinned here and borrowed by the kernel
        until the tx-release event."""
        token = self._next_token
        self._next_token += 1
        addr, keep = _payload_ptr(payload)
        # pin BEFORE the call: the pump thread may finish the entry and
        # emit the release before send2 even returns
        key = (conn_id, token)
        self._tx_pins[key] = keep
        depth = self.lib.t3fs_pump_send2(self.h, conn_id, hdr, len(hdr),
                                         addr, len(payload), token)
        if depth < 0:
            self._tx_pins.pop(key, None)
            raise make_error(StatusCode.RPC_SEND_FAILED,
                             f"pump_send2: errno {-depth}")
        return int(depth)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self.lib.t3fs_pump_stats(self.h, ctypes.byref(out))
        return {"tx_staged_bytes": int(out[0]), "tx_zc_bytes": int(out[1]),
                "rx_frames": int(out[2]), "rx_bytes": int(out[3]),
                "tx_pins": len(self._tx_pins)}

    def tx_depth(self, conn_id: int) -> int:
        return int(self.lib.t3fs_pump_tx_depth(self.h, conn_id))

    def detach(self, conn_id: int) -> None:
        self.conns.pop(conn_id, None)
        self.lib.t3fs_pump_close(self.h, conn_id)

    def destroy(self) -> None:
        if self.h is None:
            return
        if not self.loop.is_closed():
            try:
                self.loop.remove_reader(self.efd)
            except (OSError, RuntimeError):
                pass
        self.lib.t3fs_pump_destroy(self.h)
        self.h = None
        self.conns.clear()

    def _drain(self) -> None:
        if self.h is None:
            return               # destroyed; a late callback must not poll
        try:
            os.read(self.efd, 8)
        except BlockingIOError:
            pass
        while True:
            n = self.lib.t3fs_pump_poll(self.h, self._evts, 256)
            for i in range(n):
                e = self._evts[i]
                if e.kind == 2:                      # tx-release: unpin
                    self._tx_pins.pop((e.conn_id, e.data), None)
                    continue
                conn = self.conns.get(e.conn_id)
                if e.kind == 1:                      # peer closed / error
                    if conn is not None:
                        conn._on_pump_closed()
                    continue
                msg = ctypes.string_at(e.data, e.msg_len)
                if e.payload_len >= ZC_MIN:
                    # zero-copy handoff: the payload stays in the pump's
                    # buffer; the memoryview's exporter frees it when the
                    # last reference dies (plain free — safe even after
                    # pump destruction, see t3fs_pump_free)
                    arr = (ctypes.c_ubyte * e.payload_len).from_address(
                        e.data + e.msg_len)
                    weakref.finalize(arr, self.lib.t3fs_pump_free, e.data)
                    # cast to plain 'B': ctypes exports '<B', which
                    # slice-assignment into bytearray views rejects
                    payload = memoryview(arr).cast("B")
                else:
                    payload = ctypes.string_at(e.data + e.msg_len,
                                               e.payload_len)
                    self.lib.t3fs_pump_free2(self.h, e.data,
                                             e.msg_len + e.payload_len)
                if conn is not None:
                    conn._on_frame(e.flags, msg, payload)
                elif e.payload_len >= ZC_MIN:
                    del payload, arr       # orphan frame: free eagerly
            if n < 256:
                break


class NativeConnection(Connection):
    """Connection whose wire runs through the native pump.  Reuses the
    base class's call()/waiter table and request dispatch; overrides the
    byte-moving halves (read loop and frame send)."""

    def __init__(self, sock: socket.socket, pump: NativePump,
                 dispatcher=None, name: str = "?", on_close=None,
                 compress_threshold: int = 0, compress_level: int = 1):
        super().__init__(None, None, dispatcher, name, on_close,
                         compress_threshold, compress_level)
        self.sock = sock
        self.pump = pump
        self.conn_id = 0

    def start(self) -> None:
        self.conn_id = self.pump.attach(self)

    def _close_now(self) -> None:
        """Synchronous close: unlike the asyncio transport there is
        nothing to await, and failure paths need the conn marked closed
        BEFORE the caller's next _get_conn (the pump's eventfd callback
        may not have run yet when a send hits a dead conn)."""
        if self._closed:
            return
        self._closed = True
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:
                pass
        if self.conn_id:
            self.pump.detach(self.conn_id)
        try:
            self.sock.close()
        except OSError:
            pass
        err = make_error(StatusCode.RPC_SEND_FAILED,
                         f"connection {self.name} closed")
        for fut in self._waiters.values():
            if not fut.done():
                fut.set_exception(err)
                fut.exception()    # see Connection.close for why
        self._waiters.clear()

    async def close(self) -> None:
        self._close_now()

    # --- TX: assemble the frame in Python, ship it through the pump ---

    async def _send_frame(self, packet, payload: bytes, flags: int) -> None:
        head, msg, payload = await self._prep_frame(packet, payload, flags)
        async with self._send_lock:
            if self._closed:
                raise make_error(StatusCode.RPC_SEND_FAILED,
                                 "connection closed")
            try:
                if len(payload) >= ZC_MIN:
                    # bulk plane: the payload is pinned, not staged —
                    # the "SLOWER here" staging copy below is gone for
                    # the half that carried the bytes
                    depth = self.pump.send_zc(self.conn_id, head + msg,
                                              payload)
                else:
                    if payload and not isinstance(payload, bytes):
                        payload = bytes(payload)   # small: copy is fine
                    depth = self.pump.send(self.conn_id,
                                           head + msg + payload)
            except StatusError:
                # the pump saw the peer die before our eventfd callback
                # ran: close NOW so the caller's retry reconnects instead
                # of re-hitting the dead conn (the asyncio path gets the
                # same effect from its read loop exiting).
                # NOTE an end-of-tick TX-coalescing variant (batch every
                # frame of a loop tick into one submission) measured
                # SLOWER here: the extra payload copy into the staging
                # buffer and the tick-delayed first byte cost more than
                # the saved io_uring_enter calls on this box.
                self._close_now()
                raise
        # backpressure outside the lock: other senders may proceed while
        # this one waits for the pump queue to drain below the high water
        while depth > TX_HIGH_WATER:
            await asyncio.sleep(0.002)
            if self._closed:
                raise make_error(StatusCode.RPC_SEND_FAILED,
                                 f"connection {self.name} closed mid-send")
            depth = max(0, self.pump.tx_depth(self.conn_id))

    # --- RX: the pump already framed and CRC-verified ---

    def _on_frame(self, flags: int, msg: bytes, payload: bytes) -> None:
        if flags & FLAG_COMPRESS:
            # rare path: inflate off-loop, then dispatch
            self._spawn(self._dispatch_compressed(flags, msg, payload),
                        f"inflate-{self.name}")
            return
        self._dispatch(msg, payload)

    async def _dispatch_compressed(self, flags: int, msg: bytes,
                                   payload: bytes) -> None:
        from t3fs_torch.net.wire import decompress_frame
        try:
            msg, payload = await asyncio.to_thread(
                decompress_frame, msg, payload, flags)
        except Exception:
            log.warning("conn %s: bad compressed frame", self.name)
            await self.close()
            return
        self._dispatch(msg, payload)

    def _dispatch(self, msg: bytes, payload: bytes) -> None:
        try:
            packet = serde.loads(msg)
        except Exception:
            log.exception("conn %s: undecodable packet", self.name)
            self._close_now()
            return
        self._dispatch_packet(packet, payload)

    def _on_pump_closed(self) -> None:
        self._close_now()


async def native_connect(address: str, dispatcher, name: str,
                         compress_threshold: int = 0) -> NativeConnection:
    host, port = address.rsplit(":", 1)
    loop = asyncio.get_running_loop()
    # the pump first: where io_uring is refused its OSError leaves no
    # connected socket behind
    pump = NativePump.get()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setblocking(False)
    try:
        await loop.sock_connect(sock, (host, int(port)))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except BaseException:
        # incl. CancelledError from the caller's wait_for timeout — the
        # asyncio path closes its socket on cancellation too
        sock.close()
        raise
    conn = NativeConnection(sock, pump, dispatcher, name=name,
                            compress_threshold=compress_threshold)
    conn.start()
    return conn
