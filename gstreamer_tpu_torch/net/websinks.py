"""HTTP/FTP/SMTP client sinks (+ curlhttpsrc).

Clean-room analogs of:
* souphttpclientsink (gst-plugins-good/ext/soup/
  gstsouphttpclientsink.c): streams the byte stream to a server via
  HTTP PUT (stdlib http.client instead of libsoup).
* curlhttpsink / curlfilesink / curlftpsink / curlsmtpsink
  (gst-plugins-bad/ext/curl/gstcurlhttpsink.c, gstcurlfilesink.c,
  gstcurlftpsink.c, gstcurlsmtpsink.c): the libcurl upload sinks —
  HTTP PUT, file:// write, FTP STOR (stdlib ftplib) and SMTP
  attachment mail (stdlib smtplib).
* curlhttpsrc (gstcurlhttpsrc.c): HTTP GET source — registered over
  the existing souphttpsrc implementation (both reference elements
  expose the same http(s):// uri handler).

All of these buffer the stream and transmit on EOS (the curl sinks'
"transfer thread consumes the queue" collapses to one upload in the
tick model; souphttpclientsink's chunked PUT likewise).

A copy of the JAX package's ``net/websinks.py``, over the port's
``elements/ipc_misc.py``.  The sinks copy each tick's bytes to the host
(``host_array``) and take their source's host bytes (``HOST_INPUT``).
"""

from __future__ import annotations

from urllib.parse import urlparse

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            register_element)
from ..elements.ipc_misc import SoupHttpSrc


def _bytes_of(buf: Buffer) -> bytes:
    d = buf.data
    blobs = d if isinstance(d, (list, tuple)) else [d]
    return b"".join(
        b if isinstance(b, (bytes, bytearray))
        else host_array(b).ravel().astype(np.uint8).tobytes()
        for b in blobs)


class _UploadSinkBase(SinkElement):
    """Accumulate the stream; one upload at EOS (stop())."""
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "destination URI"),
    }
    HOST_INPUT = True       # takes the source's host bytes

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = bytearray()
        self.uploaded = 0                        # bytes sent (stats)

    def start(self):
        self._acc = bytearray()
        self.uploaded = 0

    def render(self, buf: Buffer) -> str:
        self._acc += _bytes_of(buf)
        return FlowReturn.OK

    def _upload(self, data: bytes) -> None:
        raise NotImplementedError

    def stop(self):
        if self._acc:
            data = bytes(self._acc)
            self._acc = bytearray()
            self._upload(data)
            self.uploaded = len(data)


@register_element
class SoupHttpClientSink(_UploadSinkBase):
    """souphttpclientsink (gstsouphttpclientsink.c): HTTP PUT of the
    stream to `location`."""
    FACTORY = "souphttpclientsink"
    DESCRIPTION = "Sends streams to HTTP server via PUT"
    PROPERTIES = dict(_UploadSinkBase.PROPERTIES)
    PROPERTIES.update({
        "user-id": (str, "", "basic-auth user"),
        "user-pw": (str, "", "basic-auth password"),
    })

    def _upload(self, data: bytes) -> None:
        import base64
        import http.client
        u = urlparse(self.props["location"])
        cls = (http.client.HTTPSConnection if u.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(u.hostname, u.port or (443 if u.scheme == "https"
                                          else 80), timeout=10)
        headers = {"Content-Type": "application/octet-stream"}
        if self.props["user-id"]:
            cred = f"{self.props['user-id']}:{self.props['user-pw']}"
            headers["Authorization"] = "Basic " + base64.b64encode(
                cred.encode()).decode()
        conn.request("PUT", u.path or "/", body=data, headers=headers)
        resp = conn.getresponse()
        resp.read()
        conn.close()
        if resp.status >= 400:
            raise RuntimeError(
                f"{self.FACTORY}: HTTP {resp.status} from "
                f"{self.props['location']}")


@register_element
class CurlHttpSink(SoupHttpClientSink):
    """curlhttpsink (gstcurlhttpsink.c): same PUT upload, curl-era
    name and property set."""
    FACTORY = "curlhttpsink"
    DESCRIPTION = "Upload data over HTTP/HTTPS protocol using libcurl"


@register_element
class CurlFileSink(_UploadSinkBase):
    """curlfilesink (gstcurlfilesink.c): file:// upload — a local
    write through the URI."""
    FACTORY = "curlfilesink"
    DESCRIPTION = "Upload data over FILE protocol using libcurl"

    def _upload(self, data: bytes) -> None:
        u = urlparse(self.props["location"])
        path = u.path if u.scheme in ("file", "") else None
        if not path:
            raise RuntimeError("curlfilesink: need a file:// location")
        with open(path, "wb") as f:
            f.write(data)


@register_element
class CurlFtpSink(_UploadSinkBase):
    """curlftpsink (gstcurlftpsink.c): FTP STOR via stdlib ftplib."""
    FACTORY = "curlftpsink"
    DESCRIPTION = "Upload data over FTP protocol using libcurl"
    PROPERTIES = dict(_UploadSinkBase.PROPERTIES)
    PROPERTIES.update({
        "user": (str, "anonymous", "FTP user"),
        "passwd": (str, "", "FTP password"),
    })

    def _upload(self, data: bytes) -> None:
        import ftplib
        import io
        u = urlparse(self.props["location"])
        ftp = ftplib.FTP()
        ftp.connect(u.hostname, u.port or 21, timeout=10)
        ftp.login(self.props["user"], self.props["passwd"])
        ftp.storbinary(f"STOR {u.path.lstrip('/')}", io.BytesIO(data))
        ftp.quit()


@register_element
class CurlSmtpSink(_UploadSinkBase):
    """curlsmtpsink (gstcurlsmtpsink.c): mails the stream as an
    attachment via stdlib smtplib."""
    FACTORY = "curlsmtpsink"
    DESCRIPTION = "Upload data over SMTP protocol using libcurl"
    PROPERTIES = dict(_UploadSinkBase.PROPERTIES)
    PROPERTIES.update({
        "mail-from": (str, "", "MAIL FROM address"),
        "mail-rcpt": (str, "", "RCPT TO address"),
        "subject": (str, "media stream", "mail subject"),
    })

    def _upload(self, data: bytes) -> None:
        import smtplib
        from email.message import EmailMessage
        u = urlparse(self.props["location"])
        msg = EmailMessage()
        msg["From"] = self.props["mail-from"]
        msg["To"] = self.props["mail-rcpt"]
        msg["Subject"] = self.props["subject"]
        msg.add_attachment(data, maintype="application",
                           subtype="octet-stream",
                           filename="stream.bin")
        with smtplib.SMTP(u.hostname, u.port or 25,
                          timeout=10) as smtp:
            smtp.send_message(msg, from_addr=self.props["mail-from"],
                              to_addrs=[self.props["mail-rcpt"]])


@register_element
class CurlHttpSrc(SoupHttpSrc):
    """curlhttpsrc (gstcurlhttpsrc.c): HTTP GET source — the same
    http(s) uri handler as souphttpsrc here."""
    FACTORY = "curlhttpsrc"
    DESCRIPTION = "Receiver data as a client over a network via HTTP"
