"""RTP payloading for raw media.

A slice of the reference RTP stack (reference:
gst-plugins-base/gst-libs/gst/rtp/gstrtpbasepayload.c (base classes),
gst-plugins-good/gst/rtp/gstrtpvrawpay.c / gstrtpvrawdepay.c (RFC 4175
uncompressed video), gstrtpL16pay.c / gstrtpL16depay.c (RFC 3551 L16
audio)).

Elements:
* rtpvrawpay / rtpvrawdepay — raw video frames <-> RFC 4175 packets
  (scan-line layout with per-packet line headers);
* rtpL16pay / rtpL16depay — interleaved S16BE audio <-> RTP;
combined with udpsink/udpsrc these form the reference's
`videotestsrc ! rtpvrawpay ! udpsink` ingest/egress pipelines.

A copy of the JAX package's ``net/rtp.py``. The payloaders copy each tick's
media to the host (``host_array``); the depayloaders of raw media put their
frames and samples on the element's device in one copy (``device_planes`` /
``device_array``), and take their source's host bytes unstaged
(``HOST_INPUT``).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import (Buffer, FlowReturn, device_array, device_planes,
                           host_array)
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from ..video.info import VideoInfo


RTP_VERSION = 2


def rtp_header(payload_type: int, seq: int, timestamp: int, ssrc: int,
               marker: bool = False, extension: bytes = b"") -> bytes:
    """12-byte RTP fixed header (RFC 3550); `extension` is a
    pre-built header-extension block (profile + length + data, e.g.
    from net/rtp_hdrext.py) and sets the X bit."""
    b0 = (RTP_VERSION << 6) | (0x10 if extension else 0)
    b1 = (0x80 if marker else 0) | (payload_type & 0x7F)
    return struct.pack("!BBHII", b0, b1, seq & 0xFFFF,
                       timestamp & 0xFFFFFFFF,
                       ssrc & 0xFFFFFFFF) + extension


def parse_rtp_header(pkt: bytes):
    b0, b1, seq, ts, ssrc = struct.unpack("!BBHII", pkt[:12])
    pos = 12 + 4 * (b0 & 0x0F)               # skip CSRCs
    ext_profile = None
    ext_data = b""
    if b0 & 0x10 and pos + 4 <= len(pkt):    # X bit (RFC 3550 §5.3.1)
        ext_profile, ext_words = struct.unpack("!HH",
                                               pkt[pos:pos + 4])
        ext_data = pkt[pos + 4:pos + 4 + 4 * ext_words]
        pos += 4 + 4 * ext_words
    return {
        "version": b0 >> 6,
        "padding": bool(b0 & 0x20),
        "marker": bool(b1 & 0x80),
        "payload_type": b1 & 0x7F,
        "seq": seq,
        "timestamp": ts,
        "ssrc": ssrc,
        "extension_profile": ext_profile,
        "extension_data": ext_data,
        "payload": pkt[pos:],
    }


def _pgroup(finfo) -> Tuple[int, int]:
    """RFC 4175 section 4.3's pixel group: (bytes, pixels).  UYVY packs two
    pixels in four bytes; the RGB family one pixel in its components.
    The JAX package takes the component count as bytes a pixel, which
    for UYVY is twice the row (its rtpvrawpay raises: ROADMAP.md
    section 3)."""
    if finfo.name == "UYVY":
        return 4, 2
    return len(finfo.packed_order), 1


@register_element
class RtpVRawPay(TransformElement):
    """rtpvrawpay (gstrtpvrawpay.c): RFC 4175 scan-line payloading of
    raw video.  Output buffers carry a LIST of packets (bytes) per
    frame; pair with udpsink for the wire."""
    FACTORY = "rtpvrawpay"
    DESCRIPTION = "Payload raw video as RTP packets (RFC 4175)"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ RGB, BGR, RGBA, BGRA, UYVY }"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "mtu": (int, 1400, "max packet size"),
        "pt": (int, 96, "payload type"),
        "ssrc": (int, 0x12345678, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps.from_string("application/x-rtp")
        else:
            res = self.sink_pads()[0].template_caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])
        fmt = self._info.finfo
        self._pgroup, self._xinc = _pgroup(fmt)

    def start(self):
        self._seq = 0

    def _pay_frame(self, frame: np.ndarray, ts: int) -> List[bytes]:
        """RFC 4175: each packet = RTP header + extended seq (2B) + one
        or more (length, line-no, offset) headers + line data."""
        h, w = self._info.height, self._info.width
        pg = self._pgroup
        row_bytes = w * pg // self._xinc
        mtu = self.props["mtu"]
        pkts = []
        line = 0
        off = 0
        data = frame.reshape(h, row_bytes)
        while line < h:
            payload_room = mtu - 12 - 2 - 6
            take = min(payload_room, row_bytes - off)
            take -= take % pg
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"],
                             marker=(line == h - 1
                                     and off + take >= row_bytes))
            self._seq += 1
            # extended seq (0) + single line header: length, line number
            # (15 bits), offset (15 bits, continuation bit 0)
            lh = struct.pack("!HHH", take, line & 0x7FFF,
                             (off // pg * self._xinc) & 0x7FFF)
            pkts.append(hdr + b"\x00\x00" + lh
                        + data[line, off:off + take].tobytes())
            off += take
            if off >= row_bytes:
                off = 0
                line += 1
        return pkts

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        # interleave component planes back to the packed wire format
        from ..video.format import to_bytes

        planes = buf.data if isinstance(buf.data, (tuple, list)) \
            else (buf.data,)
        np_planes = tuple(host_array(p) for p in planes)
        raw = to_bytes(self._info.finfo, np_planes, self._info.width,
                       self._info.height)
        raw = raw.reshape(buf.batch, -1)
        ts0 = buf.pts or 0
        dur = buf.duration or 0
        packets = []
        for k in range(buf.batch):
            ts90 = ((ts0 + k * dur) * 90000) // 1_000_000_000
            packets.extend(self._pay_frame(raw[k], ts90))
        return buf.with_(data=packets)


@register_element
class RtpVRawDepay(TransformElement):
    """rtpvrawdepay (gstrtpvrawdepay.c): reassemble RFC 4175 packets
    into raw video frames."""
    FACTORY = "rtpvrawdepay"
    DESCRIPTION = "Depayload RFC 4175 raw video from RTP"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ RGB, BGR, RGBA, BGRA, UYVY }"),
    ]
    PROPERTIES = {
        "caps": (object, None, "output video caps (format/size)"),
    }

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)
        self._frame = None
        self._ts = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = self.props["caps"]
            if res is None and caps is not None and len(caps.structures):
                # out-of-band format from the x-rtp caps (the reference
                # reads these SDP-derived fields in gstrtpvrawdepay.c
                # gst_rtp_vraw_depay_setcaps)
                f = caps.structures[0].fields
                if "width" in f and "format" in f:
                    res = Caps.from_string(
                        f"video/x-raw, format={f['format']}, "
                        f"width={f['width']}, height={f['height']}")
            if res is None:
                res = self.src_pads()[0].template_caps
        else:
            res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(outcaps[0])
        self._pgroup, self._xinc = _pgroup(self._info.finfo)
        self._frame = None

    def start(self):
        self._frame = None
        self._ts = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        from ..video.format import from_bytes

        h, w = self._info.height, self._info.width
        row_bytes = w * self._pgroup // self._xinc
        pkts = buf.data if isinstance(buf.data, list) else [
            host_array(buf.data).tobytes()]
        done = []
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            info = parse_rtp_header(pkt)
            if self._ts is None or info["timestamp"] != self._ts:
                self._ts = info["timestamp"]
                if self._frame is None:
                    self._frame = np.zeros((h, row_bytes), np.uint8)
            payload = info["payload"]
            pos = 2                                  # extended seq
            while pos + 6 <= len(payload):
                length, lineno, offset = struct.unpack(
                    "!HHH", payload[pos:pos + 6])
                cont = lineno & 0x8000
                lineno &= 0x7FFF
                pos += 6
                data = payload[pos:pos + length]
                pos += length
                if lineno < h:
                    ob = offset // self._xinc * self._pgroup
                    self._frame[lineno, ob:ob + len(data)] = np.frombuffer(
                        data, np.uint8)
                if not cont:
                    break
            if info["marker"]:
                done.append(self._frame)
                self._frame = np.zeros((h, row_bytes), np.uint8)
        if not done:
            return None
        frames = np.stack(done)
        planes = from_bytes(self._info.finfo, frames.reshape(len(done), -1),
                            w, h)
        return buf.with_(data=device_planes(planes, resolve(self.device)),
                         batch=len(done))


@register_element
class RtpL16Pay(TransformElement):
    """rtpL16pay (RFC 3551): S16 interleaved audio -> RTP packets."""
    FACTORY = "rtpL16pay"
    DESCRIPTION = "Payload L16 audio as RTP packets"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-raw, format=S16LE"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "mtu": (int, 1400, ""),
        "pt": (int, 96, ""),
        "ssrc": (int, 0xBEEF, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0
        self._ts = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..audio.info import AudioInfo
        self._ainfo = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._seq = 0
        self._ts = 0

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        x = host_array(buf.data)          # (frames, ch) int16
        ch = x.shape[1]
        be = x.astype(">i2").tobytes()    # L16 is big-endian on the wire
        bpf = 2 * ch
        room = (self.props["mtu"] - 12) // bpf * bpf
        pkts = []
        for off in range(0, len(be), room):
            chunk = be[off:off + room]
            hdr = rtp_header(self.props["pt"], self._seq, self._ts,
                             self.props["ssrc"])
            self._seq += 1
            self._ts += len(chunk) // bpf
            pkts.append(hdr + chunk)
        return buf.with_(data=pkts)


@register_element
class RtpL16Depay(TransformElement):
    """rtpL16depay: RTP packets -> S16 interleaved audio."""
    FACTORY = "rtpL16depay"
    DESCRIPTION = "Depayload L16 audio from RTP"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "audio/x-raw, format=S16LE"),
    ]
    PROPERTIES = {
        "caps": (object, None, "output audio caps (rate/channels)"),
    }

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = self.props["caps"] or self.src_pads()[0].template_caps
        else:
            res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..audio.info import AudioInfo
        self._ainfo = AudioInfo.from_caps_structure(outcaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        pkts = buf.data if isinstance(buf.data, list) else [
            host_array(buf.data).tobytes()]
        chunks = []
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            info = parse_rtp_header(pkt)
            chunks.append(info["payload"])
        raw = b"".join(chunks)
        ch = self._ainfo.channels
        x = np.frombuffer(raw, ">i2").reshape(-1, ch).astype(np.int16)
        return buf.with_(data=device_array(x, resolve(self.device)))


@register_element
class RtpJitterBuffer(TransformElement):
    """rtpjitterbuffer (gst-plugins-good/gst/rtpmanager/
    gstrtpjitterbuffer.c): reorders RTP packets by sequence number with
    16-bit wraparound, drops duplicates and too-late packets, and
    declares packets lost once the buffered span exceeds the configured
    latency (latency property, default 200 ms; seqnum compare per
    gstrtpbuffer.c gst_rtp_buffer_compare_seqnum: (int16)(s2-s1)).

    Host element operating on list-of-packet buffers (the framework's
    RTP wire convention).  Lost packets emit a GAP event downstream
    when do-lost is set, like the reference's do-lost property.
    `stats` mirrors the reference's num-pushed/num-lost/num-late/
    num-duplicates structure."""
    FACTORY = "rtpjitterbuffer"
    DESCRIPTION = "Reorders and deduplicates RTP packets"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "latency": (int, 200, "buffering latency (ms)"),
        "do-lost": (bool, False, "emit GAP events for lost packets"),
        "drop-on-latency": (bool, False, "drop when over latency"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._store = {}            # seq -> packet bytes
        self._next_seq = None
        self._last_buf = None
        self._decouple = True       # participate in the EOS drain pass
        self._clock_rate = 90000
        self.stats = {"num-pushed": 0, "num-lost": 0, "num-late": 0,
                      "num-duplicates": 0}

    def set_info(self, incaps, outcaps):
        rate = incaps[0].get("clock-rate")
        if isinstance(rate, int) and rate > 0:
            self._clock_rate = rate

    def start(self):
        self._store.clear()
        self._next_seq = None
        self._last_buf = None

    @staticmethod
    def _seq_lt(a: int, b: int) -> bool:
        """a before b with 16-bit wraparound (gstrtpbuffer.c)."""
        return ((b - a) & 0xFFFF) < 0x8000 and a != b

    def _latency_ts(self) -> int:
        return self.props["latency"] * self._clock_rate // 1000

    def _drain(self, flush: bool = False):
        """Pop the in-order run at the head; on a gap, wait until the
        buffered timestamp span exceeds latency (or flush), then skip
        the missing seqnums as lost."""
        out = []
        lost = 0
        while self._store:
            if self._next_seq in self._store:
                out.append(self._store.pop(self._next_seq))
                self._next_seq = (self._next_seq + 1) & 0xFFFF
                continue
            # head gap: compare newest vs oldest buffered RTP time
            seqs = sorted(self._store,
                          key=lambda s: (s - self._next_seq) & 0xFFFF)
            oldest = parse_rtp_header(self._store[seqs[0]])["timestamp"]
            newest = parse_rtp_header(self._store[seqs[-1]])["timestamp"]
            span = (newest - oldest) & 0xFFFFFFFF
            if not flush and span <= self._latency_ts():
                break
            lost += (seqs[0] - self._next_seq) & 0xFFFF
            self._next_seq = seqs[0]
        return out, lost

    # EOS-drain integration: the pipeline flushes any host element with
    # _decouple set whose _pending_buf is non-None by calling
    # host_process(None) (Pipeline._propagate drain path)
    @property
    def _pending_buf(self):
        return self._last_buf if self._store else None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                 # EOS drain: flush whatever is left
            out, lost = self._drain(flush=True)
            self.stats["num-lost"] += lost
            if not out:
                return None
            self.stats["num-pushed"] += len(out)
            return self._last_buf.with_(data=out, batch=len(out))
        self._last_buf = buf
        pkts = buf.data if isinstance(buf.data, list) else [
            host_array(buf.data).tobytes()]
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            seq = parse_rtp_header(pkt)["seq"]
            if self._next_seq is None:
                self._next_seq = seq
            if seq in self._store:
                self.stats["num-duplicates"] += 1
                continue
            if self._seq_lt(seq, self._next_seq):
                # before first output the base may move backwards (a
                # reordered head packet is not "late" yet)
                if self.stats["num-pushed"] == 0:
                    self._next_seq = seq
                else:
                    self.stats["num-late"] += 1
                    continue
            self._store[seq] = pkt
        out, lost = self._drain()
        if lost:
            self.stats["num-lost"] += lost
            if self.props["do-lost"]:
                from ..core.events import gap_event
                for p in self.src_pads():
                    p.push_event(gap_event(buf.pts or 0, 0))
        if not out:
            return None
        self.stats["num-pushed"] += len(out)
        return buf.with_(data=out, batch=len(out))
