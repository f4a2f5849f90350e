"""pcapparse — extract UDP/TCP payloads from pcap capture files.

Port of gst-plugins-bad/gst/pcapparse/gstpcapparse.c:
* the four magic numbers (ms/ns timestamps x both endians, :62-65),
  global header linktype check (ETHER/SLL/SLL2/RAW, :663),
* per-record 16-byte headers driving packet framing with pts =
  ts_sec * GST_SECOND + ts_usec * (GST_USECOND or 1ns) + ts-offset
  (:617),
* scan_frame (:360-480): ethernet (with 802.1Q VLAN skip) / SLL /
  SLL2 / raw link layers -> IPv4 only, fragments rejected, UDP
  payload after the 8-byte header or TCP payload after the data
  offset, filtered by src-ip/dst-ip/src-port/dst-port,
* the `caps` property sets the src caps (e.g. application/x-rtp for
  feeding rtp depayloaders).

A copy of the JAX package's ``elements/pcapparse.py``. Host code only, on
the port's ``audioparsers._ParserBase``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..core.caps import Caps
from ..core.element import PadDirection, PadTemplate, register_element
from .audioparsers import _ParserBase

_MAGIC_MS = 0xA1B2C3D4
_MAGIC_NS = 0xA1B23C4D
LINKTYPE_ETHER, LINKTYPE_RAW, LINKTYPE_SLL, LINKTYPE_SLL2 = \
    1, 101, 113, 276
_ETH_HEADER_LEN = 14
_ETH_VLAN_HEADER_LEN = 4
_SLL_HEADER_LEN = 16
_SLL2_HEADER_LEN = 20
_IP_HEADER_MIN_LEN = 20
_UDP_HEADER_LEN = 8
_TCP_HEADER_MIN_LEN = 20


def _ip_to_u32(s: str) -> Optional[int]:
    if not s:
        return None
    parts = s.split(".")
    if len(parts) != 4:
        return None
    v = 0
    for p in parts:
        v = (v << 8) | (int(p) & 0xFF)
    return v


def scan_frame(data: bytes, linktype: int,
               src_ip=None, dst_ip=None, src_port=None, dst_port=None
               ) -> Optional[Tuple[int, int]]:
    """(payload_offset, payload_size) or None (gstpcapparse.c:360)."""
    n = len(data)
    if linktype == LINKTYPE_ETHER:
        if n < _ETH_HEADER_LEN + _IP_HEADER_MIN_LEN + _UDP_HEADER_LEN:
            return None
        eth_type = struct.unpack(">H", data[12:14])[0]
        if eth_type == 0x8100:                   # 802.1Q VLAN
            if n < (_ETH_HEADER_LEN + _ETH_VLAN_HEADER_LEN
                    + _IP_HEADER_MIN_LEN + _UDP_HEADER_LEN):
                return None
            eth_type = struct.unpack(
                ">H", data[12 + _ETH_VLAN_HEADER_LEN:
                           14 + _ETH_VLAN_HEADER_LEN])[0]
            ip_off = _ETH_HEADER_LEN + _ETH_VLAN_HEADER_LEN
        else:
            ip_off = _ETH_HEADER_LEN
    elif linktype == LINKTYPE_SLL:
        if n < _SLL_HEADER_LEN + _IP_HEADER_MIN_LEN + _UDP_HEADER_LEN:
            return None
        eth_type = struct.unpack(">H", data[14:16])[0]
        ip_off = _SLL_HEADER_LEN
    elif linktype == LINKTYPE_SLL2:
        if n < _SLL2_HEADER_LEN + _IP_HEADER_MIN_LEN + _UDP_HEADER_LEN:
            return None
        eth_type = struct.unpack(">H", data[0:2])[0]
        ip_off = _SLL2_HEADER_LEN
    elif linktype == LINKTYPE_RAW:
        if n < _IP_HEADER_MIN_LEN + _UDP_HEADER_LEN:
            return None
        eth_type = 0x800
        ip_off = 0
    else:
        return None
    if eth_type != 0x800:
        return None
    b = data[ip_off]
    if (b >> 4) & 0x0F != 4:                     # IPv4 only
        return None
    ihl = (b & 0x0F) * 4
    if ihl < _IP_HEADER_MIN_LEN or ip_off + ihl > n:
        return None
    flags = data[ip_off + 6] >> 5
    frag = (struct.unpack(">H", data[ip_off + 6:ip_off + 8])[0]
            & 0x1FFF) * 8
    if flags & 0x1 or frag > 0:                  # fragments rejected
        return None
    proto = data[ip_off + 9]
    if proto not in (17, 6):                     # UDP / TCP
        return None
    ip_src = struct.unpack(">I", data[ip_off + 12:ip_off + 16])[0]
    ip_dst = struct.unpack(">I", data[ip_off + 16:ip_off + 20])[0]
    ip_len = struct.unpack(">H", data[ip_off + 2:ip_off + 4])[0]
    if ip_len < ihl:
        return None
    po = ip_off + ihl
    if po + 4 > n:
        return None
    sport, dport = struct.unpack(">HH", data[po:po + 4])
    if proto == 17:
        if po + 6 > n:
            return None
        ulen = struct.unpack(">H", data[po + 4:po + 6])[0]
        if ulen < _UDP_HEADER_LEN or po + ulen > n:
            return None
        off, size = po + _UDP_HEADER_LEN, ulen - _UDP_HEADER_LEN
    else:
        if po + 13 > n:
            return None
        thl = (data[po + 12] >> 4) * 4
        if thl < _TCP_HEADER_MIN_LEN or po + thl > n:
            return None
        if ip_len < ihl + thl or ip_off + ip_len > n:
            return None
        off, size = po + thl, ip_len - ihl - thl
    if src_ip is not None and ip_src != src_ip:
        return None
    if dst_ip is not None and ip_dst != dst_ip:
        return None
    if src_port is not None and sport != src_port:
        return None
    if dst_port is not None and dport != dst_port:
        return None
    return off, size


@register_element
class PcapParse(_ParserBase):
    FACTORY = "pcapparse"
    DESCRIPTION = "Parses a raw pcap stream"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "raw/x-pcap"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    _SRC_CAPS = "application/octet-stream"
    PROPERTIES = {
        "src-ip": (str, "", "source IP filter"),
        "dst-ip": (str, "", "destination IP filter"),
        "src-port": (int, -1, "source port filter (-1 = any)"),
        "dst-port": (int, -1, "destination port filter (-1 = any)"),
        "caps": (object, None, "caps to set on the src pad"),
        "ts-offset": (int, 0, "ns added to each packet pts"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(24)
        self._state = "global"
        self._swap = False
        self._nanos = False
        self._linktype = 0
        self._payload: Optional[Tuple[int, int, int]] = None
        self._post_skip = 0
        self._ptss: List[int] = []

    def start(self):
        super().start()
        self._state = "global"
        self._payload = None
        self._post_skip = 0
        self._ptss = []

    def _u32(self, b: bytes) -> int:
        return struct.unpack(self._fmt, b)[0]

    _fmt = ">I"

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        if self._state == "global":
            magic_be = struct.unpack(">I", raw[0:4])[0]
            magic_le = struct.unpack("<I", raw[0:4])[0]
            # the reference reads native-endian and flips on mismatch
            # (:637-646); equivalent: accept either byte order
            if magic_le in (_MAGIC_MS, _MAGIC_NS):
                self._fmt = "<I"             # little-endian file
                self._nanos = magic_le == _MAGIC_NS
            elif magic_be in (_MAGIC_MS, _MAGIC_NS):
                self._fmt = ">I"
                self._nanos = magic_be == _MAGIC_NS
            else:
                raise ValueError("pcapparse: bad magic")
            self._linktype = self._u32(raw[20:24])
            if self._linktype not in (LINKTYPE_ETHER, LINKTYPE_SLL,
                                      LINKTYPE_SLL2, LINKTYPE_RAW):
                raise ValueError("pcapparse: unsupported linktype %d"
                                 % self._linktype)
            self._state = "record"
            self.set_min_frame_size(16)
            return 0, 24
        if self._payload is not None:
            _, size, tail = self._payload
            self._payload = None
            self._post_skip = tail
            self.set_min_frame_size(16)
            return size, 0
        if getattr(self, "_post_skip", 0) > 0:
            skip, self._post_skip = self._post_skip, 0
            if skip > 0:
                return 0, skip
        if len(raw) < 16:
            return 0, 0
        ts_sec = self._u32(raw[0:4])
        ts_frac = self._u32(raw[4:8])
        incl = self._u32(raw[8:12])
        if len(raw) < 16 + incl:
            return 0, 0
        pkt = raw[16:16 + incl]
        res = scan_frame(
            pkt, self._linktype,
            _ip_to_u32(self.props["src-ip"]),
            _ip_to_u32(self.props["dst-ip"]),
            self.props["src-port"] if self.props["src-port"] >= 0
            else None,
            self.props["dst-port"] if self.props["dst-port"] >= 0
            else None)
        if res is None:
            return 0, 16 + incl
        off, size = res
        if size == 0:
            return 0, 16 + incl
        pts = ts_sec * 1_000_000_000 \
            + ts_frac * (1 if self._nanos else 1000) \
            + self.props["ts-offset"]
        self._ptss.append(pts)
        self._payload = (0, size, incl - off - size)
        self.set_min_frame_size(size)    # payload may be < 16 bytes
        return 0, 16 + off

    def transform_caps(self, direction, caps, filter=None):
        # the caps property is the src pad's caps (gstpcapparse.c sets
        # them on the pad); the JAX package only tags the buffers with
        # them, so a depayloader after it cannot link (ROADMAP.md
        # section 3)
        want = self.props["caps"]
        if direction == PadDirection.SINK and want is not None:
            res = want if isinstance(want, Caps) \
                else Caps.from_string(str(want))
            return res.intersect(filter) if filter is not None else res
        return super().transform_caps(direction, caps, filter)

    def pre_push_frame(self, buf):
        n = buf.batch or 1
        pts = self._ptss[0] if self._ptss else buf.pts
        del self._ptss[:n]
        caps = self.props["caps"]
        if caps is not None:
            if not isinstance(caps, Caps):
                caps = Caps.from_string(str(caps))
            buf = buf.with_(meta=dict(buf.meta or {}, caps=caps))
        return buf.with_(pts=pts)
