"""Network clock sync — GstNetTimeProvider / GstNetClientClock equivalents.

Reference: subprojects/gstreamer/libs/gst/net/ — gstnettimepacket.c
(16-byte packet: local_time u64 BE + remote_time u64 BE, :63-120),
gstnettimeprovider.c (UDP echo server stamping remote_time),
gstnetclientclock.c (RTT observations -> clock slaving), and the
master/slave calibration in gstclock.c (gst_clock_add_observation :1441
feeding a linear regression over (internal, external) samples,
gstutils.c gst_calculate_linear_regression).

Only host wall-clocks need cross-machine sync (device step counters are
derived); this implements the same UDP time protocol over localhost/ LAN
sockets with least-squares calibration.

A copy of the JAX package's ``net/clock.py``. Host code only: nothing in
it touches a device.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

CLOCK_TIME_NONE = (1 << 64) - 1
PACKET_SIZE = 16


def monotonic_ns() -> int:
    return time.monotonic_ns()


class SystemClock:
    """gst_system_clock_obtain equivalent (monotonic, ns)."""

    def get_time(self) -> int:
        return monotonic_ns()


class NetTimePacket:
    """gst_net_time_packet_new/serialize (gstnettimepacket.c:63,:95)."""

    def __init__(self, local_time: int = CLOCK_TIME_NONE,
                 remote_time: int = CLOCK_TIME_NONE):
        self.local_time = local_time
        self.remote_time = remote_time

    @classmethod
    def from_bytes(cls, buf: bytes) -> "NetTimePacket":
        lt, rt = struct.unpack(">QQ", buf[:PACKET_SIZE])
        return cls(lt, rt)

    def to_bytes(self) -> bytes:
        return struct.pack(">QQ", self.local_time & (2**64 - 1),
                           self.remote_time & (2**64 - 1))


class NetTimeProvider:
    """UDP echo server: receives a packet, stamps remote_time with its
    clock, sends it back (gstnettimeprovider.c io_callback)."""

    def __init__(self, clock: Optional[SystemClock] = None,
                 address: str = "127.0.0.1", port: int = 0):
        self.clock = clock or SystemClock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self.address, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._sock.settimeout(0.1)
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(PACKET_SIZE)
            except socket.timeout:
                continue
            except OSError:
                break
            pkt = NetTimePacket.from_bytes(data)
            pkt.remote_time = self.clock.get_time()
            try:
                self._sock.sendto(pkt.to_bytes(), addr)
            except OSError:
                break

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self._sock.close()


def linear_regression(xs: List[int], ys: List[int]
                      ) -> Tuple[float, float, float]:
    """gst_calculate_linear_regression (gstutils.c): least squares
    y = m*x + b over clock observations; returns (m, b, r_squared)."""
    import numpy as np

    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    xbar, ybar = x.mean(), y.mean()
    sxx = ((x - xbar) ** 2).sum()
    sxy = ((x - xbar) * (y - ybar)).sum()
    if sxx == 0:
        return 1.0, ybar - xbar, 0.0
    m = sxy / sxx
    b = ybar - m * xbar
    syy = ((y - ybar) ** 2).sum()
    r2 = 0.0 if syy == 0 else (sxy * sxy) / (sxx * syy)
    return m, b, r2


class NetClientClock:
    """Slave clock calibrated against a NetTimeProvider.

    observe() performs one round trip (gstnetclientclock.c
    gst_net_client_internal_clock_observe_times): the remote time is
    paired with the midpoint of (send_local, recv_local); observations
    feed a linear regression mapping local -> remote."""

    def __init__(self, address: str, port: int,
                 clock: Optional[SystemClock] = None, window: int = 32):
        self.remote = (address, port)
        self.clock = clock or SystemClock()
        self.window = window
        self._obs: List[Tuple[int, int]] = []   # (local_mid, remote)
        self._m, self._b = 1.0, 0.0
        self._r2 = 0.0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.settimeout(1.0)
        self.round_trips: List[int] = []

    def observe(self) -> bool:
        send_local = self.clock.get_time()
        pkt = NetTimePacket(local_time=send_local)
        self._sock.sendto(pkt.to_bytes(), self.remote)
        try:
            data, _ = self._sock.recvfrom(PACKET_SIZE)
        except socket.timeout:
            return False
        recv_local = self.clock.get_time()
        rsp = NetTimePacket.from_bytes(data)
        if rsp.local_time != send_local:
            return False   # stale response
        local_mid = (send_local + recv_local) // 2
        self.round_trips.append(recv_local - send_local)
        self._obs.append((local_mid, rsp.remote_time))
        if len(self._obs) > self.window:
            self._obs.pop(0)
        if len(self._obs) >= 2:
            xs, ys = zip(*self._obs)
            self._m, self._b, self._r2 = linear_regression(list(xs),
                                                           list(ys))
        else:
            self._m, self._b = 1.0, rsp.remote_time - local_mid
        return True

    def sync(self, n: int = 8) -> bool:
        ok = 0
        for _ in range(n):
            if self.observe():
                ok += 1
        return ok >= 2

    def get_time(self) -> int:
        """Local clock mapped into the provider's time domain."""
        return int(self._m * self.clock.get_time() + self._b)

    @property
    def calibration(self) -> Tuple[float, float, float]:
        return self._m, self._b, self._r2

    def close(self):
        self._sock.close()


# ---------------------------------------------------------------------------
# PTP (IEEE 1588) — gstptpclock.c equivalent
# ---------------------------------------------------------------------------

import struct as _struct
import threading as _threading


class PtpProvider:
    """Minimal two-step PTP master over UDP (the test/master side of the
    IEEE1588 delay mechanism the reference's gstptpclock.c follows):
    answers SYNC requests with (SYNC t1 origin) + FOLLOW_UP precise t1,
    and DELAY_REQ with DELAY_RESP carrying t4."""

    MSG_SYNC_REQ = 0       # slave asks for a sync round
    MSG_SYNC = 1
    MSG_FOLLOW_UP = 2
    MSG_DELAY_REQ = 3
    MSG_DELAY_RESP = 4

    def __init__(self, clock: Optional[SystemClock] = None,
                 address: str = "127.0.0.1", port: int = 0):
        import socket

        self.clock = clock or SystemClock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self.port = self._sock.getsockname()[1]
        self._sock.settimeout(0.1)
        self._running = False
        self._thread: Optional[_threading.Thread] = None

    def start(self):
        self._running = True
        self._thread = _threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        import socket

        while self._running:
            try:
                data, addr = self._sock.recvfrom(64)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(data) < 10:
                continue
            msg, seq = _struct.unpack("!BxQ", data[:10])
            if msg == self.MSG_SYNC_REQ:
                t1 = self.clock.get_time()
                self._sock.sendto(
                    _struct.pack("!BxQQ", self.MSG_SYNC, seq, t1), addr)
                # two-step: precise origin timestamp in FOLLOW_UP
                self._sock.sendto(
                    _struct.pack("!BxQQ", self.MSG_FOLLOW_UP, seq, t1),
                    addr)
            elif msg == self.MSG_DELAY_REQ:
                t4 = self.clock.get_time()
                self._sock.sendto(
                    _struct.pack("!BxQQ", self.MSG_DELAY_RESP, seq, t4),
                    addr)

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(1.0)
        self._sock.close()


class PtpClock:
    """PTP slave clock (gstptpclock.c): runs the delay mechanism —
        offset = ((t2 - t1) - (t4 - t3)) / 2
    and slaves the local monotonic clock through the same linear
    regression as GstNetClientClock."""

    def __init__(self, address: str, port: int, window: int = 32):
        import socket
        from collections import deque as _deque

        self._addr = (address, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.settimeout(1.0)
        self._seq = 0
        self._obs = _deque(maxlen=window)
        self._m, self._b = 1.0, 0.0
        self._r2 = 0.0
        self.synced = False

    def _recv_msg(self, want_msg, want_seq):
        while True:
            data, _ = self._sock.recvfrom(64)
            if len(data) >= 18:
                msg, seq, t = _struct.unpack("!BxQQ", data[:18])
                if msg == want_msg and seq == want_seq:
                    return t

    def observe(self) -> bool:
        """One SYNC + DELAY_REQ round; records (local, master) sample."""
        import socket

        self._seq += 1
        seq = self._seq
        try:
            self._sock.sendto(
                _struct.pack("!BxQ", PtpProvider.MSG_SYNC_REQ, seq),
                self._addr)
            t2 = monotonic_ns()
            self._recv_msg(PtpProvider.MSG_SYNC, seq)
            t1 = self._recv_msg(PtpProvider.MSG_FOLLOW_UP, seq)
            t3 = monotonic_ns()
            self._sock.sendto(
                _struct.pack("!BxQ", PtpProvider.MSG_DELAY_REQ, seq),
                self._addr)
            t4 = self._recv_msg(PtpProvider.MSG_DELAY_RESP, seq)
        except (socket.timeout, OSError):
            return False
        # IEEE1588: offset from master = ((t2-t1) - (t4-t3)) / 2
        offset = ((t2 - t1) - (t4 - t3)) // 2
        local = (t2 + t3) // 2
        self._obs.append((local, local - offset))
        if len(self._obs) >= 4:
            xs, ys = zip(*self._obs)
            self._m, self._b, self._r2 = linear_regression(list(xs),
                                                           list(ys))
            self.synced = True
        return True

    def sync(self, n: int = 8) -> bool:
        ok = 0
        for _ in range(n):
            if self.observe():
                ok += 1
        return self.synced and ok > 0

    def get_time(self) -> int:
        return int(self._m * monotonic_ns() + self._b)

    def close(self):
        self._sock.close()
