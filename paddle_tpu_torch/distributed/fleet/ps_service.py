"""Socket framing of the parameter-server RPC layer (counterpart of
``paddle_tpu/distributed/fleet/ps_service.py``, its wire framing only).

Frames are length-prefixed binary: a small pickled header, with numpy
payloads riding out of band as raw buffers (never pickled), sent with
scatter-gather ``sendmsg``.  The elastic coordinator and its clients
speak this framing; the PS server and client (replication, the zero-copy
pull wire, chaos on the wire) keep the same module name and arrive with
the PS-service slice (ROADMAP queue item 6).
"""
from __future__ import annotations

import pickle
import socket
import struct
from typing import Tuple

import numpy as np

__all__ = []

_HDR = struct.Struct("!I")


def _parse_ep(e) -> Tuple[str, int]:
    h, p = str(e).rsplit(":", 1)
    return h, int(p)


def _extract_arrays(obj):
    """Split top-level ndarray values out of a dict message: returns
    (picklable header object, list of contiguous arrays)."""
    arrays = []
    if isinstance(obj, dict) and any(isinstance(v, np.ndarray)
                                     for v in obj.values()):
        plain, meta = {}, []
        for k, v in obj.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                v = np.ascontiguousarray(v)
                meta.append((k, v.dtype.str, v.shape))
                arrays.append(v)
            else:
                plain[k] = v
        plain["__arrays__"] = meta
        obj = plain
    return obj, arrays


def _send_msg_raw(sock: socket.socket, obj):
    """Frame: [!I header_len][pickled header][raw array payloads...].

    Top-level numpy values in a dict message ride OUT OF BAND: the
    header pickles only their (key, dtype, shape) metadata and the
    buffers follow as raw bytes via scatter-gather ``sendmsg`` — the
    data plane (ids / grads / pulled rows) is never pickled or copied
    into an intermediate frame, so a pull/push RPC against the native
    table costs one small header pickle plus direct buffer writes."""
    obj, arrays = _extract_arrays(obj)
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    parts = [memoryview(_HDR.pack(len(data)) + data)]
    parts += [memoryview(a).cast("B") for a in arrays if a.nbytes]
    _sendall_vec(sock, parts)


def _send_msg(sock: socket.socket, obj):
    """Framing entry point of the PS data plane.  The reference routes
    every frame through an installed chaos plan here; the port's chaos
    module has no wire-site faults yet (ROADMAP queue item 6), so this
    is the raw frame."""
    _send_msg_raw(sock, obj)


def _frame_bytes(obj) -> bytes:
    """The exact wire bytes of a frame, as one buffer (what a chaos
    harness cuts to sever a connection mid-frame)."""
    obj, arrays = _extract_arrays(obj)
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join([_HDR.pack(len(data)), data]
                    + [a.tobytes() for a in arrays if a.nbytes])


# sendmsg is limited to IOV_MAX iovecs per call (1024 on Linux) — a
# bigger batch fails with EMSGSIZE, which the zero-copy pull path (one
# iovec per arena row) would hit on any large pull
_IOV_MAX = 1024


def _sendall_vec(sock, views):
    """sendall for a list of buffers without concatenating them (one
    syscall per <=IOV_MAX sendmsg window, zero staging copies).

    Capability is probed ONCE up front: the no-``sendmsg`` fallback is
    a per-view ``sendall`` — byte-identical wire output, since the
    frame is defined as the concatenation of the views either way.
    Partial sends (full socket buffer) consume from the front of the
    view list and re-enter; EINTR retries the same window (PEP 475
    covers most of it, but a handler that swallows the signal can
    still surface InterruptedError here)."""
    views = [v for v in views if len(v)]   # a 0-length view would make
    if not hasattr(sock, "sendmsg"):       # the consume loop spin
        for v in views:
            sock.sendall(v)
        return
    i, n = 0, len(views)
    while i < n:
        try:
            sent = sock.sendmsg(views[i:i + _IOV_MAX])
        except InterruptedError:
            continue
        # consume by CURSOR, not pop(0): a fully-sent window advances
        # in O(window), where popping each view from the front of a
        # long list would be quadratic in the iovec count
        while sent > 0:
            lv = len(views[i])
            if sent >= lv:
                sent -= lv
                i += 1
            else:
                # partial view: memoryview first so slicing a bytes /
                # ctypes part re-references instead of copying
                views[i] = memoryview(views[i])[sent:]
                sent = 0


def _recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    data = _recv_exact(sock, n)
    if data is None:
        return None
    msg = pickle.loads(data)
    if isinstance(msg, dict) and "__arrays__" in msg:
        for k, dt, shape in msg.pop("__arrays__"):
            dtype = np.dtype(dt)
            count = int(np.prod(shape)) if shape else 1
            buf = _recv_exact(sock, count * dtype.itemsize)
            if buf is None:
                return None
            # bytearray-backed: the receiver may mutate in place
            msg[k] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return msg


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            return None
        got += r
    return buf
