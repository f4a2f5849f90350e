"""Network elements of the port: RTP, RTCP, the header extensions, the
UDP/TCP transports, SDP and RTSP (client and server), the rest of the
payloaders, RED, ULPFEC and SMPTE 2022-1 FEC.

The JAX package's ``net/__init__.py`` imports ``net/clock.py``
(NetClientClock, NetTimeProvider and the rest); that module is not ported
yet and waits in ROADMAP.md, so this package imports nothing.  The element
modules register their factories when ``elements/__init__.py`` imports
them.
"""
