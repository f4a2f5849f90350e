"""Network elements of the port: RTP, RTCP, the header extensions, the
UDP/TCP transports, SDP and RTSP (client and server), the payloaders, RED,
ULPFEC and SMPTE 2022-1 FEC, WebRTC (ICE, DTLS-SRTP, SCTP, webrtcbin),
RIST, SRT, RTMP, HLS/DASH/MSS, AVTP, the socket fan-out, RFB, the web
sinks, and the network clock.

As the JAX package's ``net/__init__.py``, this package exports the clock
(``net/clock.py``); the element modules register their factories when
``elements/__init__.py`` imports them.
"""

from .clock import (NetClientClock, NetTimePacket, NetTimeProvider,
                    SystemClock)

__all__ = ["NetTimePacket", "NetTimeProvider", "NetClientClock",
           "SystemClock"]
