"""File I/O elements: filesrc/filesink (raw + y4m), multifilesrc/sink,
videoparse/audioparse (rawparse equivalents).

References: subprojects/gstreamer/plugins/elements/gstfilesrc.c,
gstfilesink.c; gst-plugins-base/gst/rawparse/ (raw video/audio from byte
streams); y4m handling mirrors gst-plugins-good's y4mdec/y4menc
(YUV4MPEG2 headers).

The JAX package's ``elements/file_elements.py`` on torch.  The host side
reads/writes bytes and converts to component planes at the boundary
(``video.format.from_bytes`` / ``to_bytes``); device code never sees file
layouts.  Sinks bring the pipeline's tensors to the host before writing.

The ingest fast path: for the planar formats of ``_SPLITTABLE`` filesrc
emits each tick's frames as ONE contiguous (n, frame_size) uint8 array,
staged to the device in one copy, and its ``generator_fn`` splits the planes
on the device as tensor views.  y4m is read by ``READERS`` native mmap
readers (``native/io.py``) when g++ is present, each copying its share of a
tick's frames in a thread of its own (a ctypes call releases the GIL),
straight into a page-locked buffer when the pipeline runs on CUDA (the one
host copy of a frame; the staging copy stream takes it from there);
``native_batches`` counts the ticks they delivered.  Every read seeks, so a
seek moves nothing but the frame index; the reference restarts its one
prefetching reader.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)
from ..core.value import Fraction
from ..native import io as native_io
from ..video.format import frame_size, from_bytes, to_bytes
from ..video.info import VideoInfo


@register_element
class FileSrc(SourceElement):
    """filesrc: typefinds y4m; raw video/audio needs caps= or a parser."""
    FACTORY = "filesrc"
    DESCRIPTION = "Read stream from a file"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "file path"),
        "caps": (object, None, "caps of raw data (videoparse shortcut)"),
        "blocksize": (int, 4096, "bytes per buffer for unknown data"),
    }

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)
        self._file = None
        self._video_info: Optional[VideoInfo] = None
        self._audio_info: Optional[AudioInfo] = None
        self._frame_idx = 0
        self._y4m_frame_prefix = False
        self._native = []
        self._pool = None
        self.native_batches = 0

    # -- typefind / negotiation -------------------------------------------
    def _sniff(self):
        loc = self.props["location"]
        if not loc or not os.path.exists(loc):
            raise FileNotFoundError(f"filesrc: no such file {loc!r}")
        with open(loc, "rb") as f:
            head = f.read(256)
        if head.startswith(b"YUV4MPEG2 "):
            hdr = head.split(b"\n", 1)[0].decode()
            params = dict()
            for tok in hdr.split()[1:]:
                params[tok[0]] = tok[1:]
            w = int(params["W"])
            h = int(params["H"])
            fps = params.get("F", "30:1").split(":")
            fmt = {"420": "I420", "420jpeg": "I420", "420mpeg2": "I420",
                   "422": "Y42B", "444": "Y444", "mono": "GRAY8",
                   }.get(params.get("C", "420jpeg"), "I420")
            self._video_info = VideoInfo(
                format=fmt, width=w, height=h,
                fps=Fraction(int(fps[0]), int(fps[1])))
            self._y4m_header_len = len(hdr) + 1
            self._y4m_frame_prefix = True
            return
        caps = self.props["caps"]
        if caps is not None:
            s = caps[0]
            if s.name == "video/x-raw":
                self._video_info = VideoInfo.from_caps_structure(s)
            elif s.name == "audio/x-raw":
                self._audio_info = AudioInfo.from_caps_structure(s)

    def set_property(self, key, value):
        # mid-stream `location` change = new stream, possibly new caps:
        # mark RECONFIGURE so the pipeline renegotiates before the next
        # batch (gstbasesrc.c renegotiate-on-reconfigure path)
        if key.replace("_", "-") == "location" \
                and getattr(self, "_file", None) is not None \
                and value != self.props.get("location"):
            super().set_property(key, value)
            self._video_info = None
            self._audio_info = None
            self._needs_reconfigure = True
            return
        super().set_property(key, value)

    def duration_ns(self):
        """DURATION query: total stream time from the file size."""
        try:
            if self._video_info is None and self._audio_info is None:
                self._sniff()
            loc = self.props["location"]
            sz = os.path.getsize(loc)
            if self._video_info is not None:
                info = self._video_info
                fsz = frame_size(info.finfo, info.width, info.height)
                per = fsz + (6 if self._y4m_frame_prefix else 0)
                base = getattr(self, "_y4m_header_len", 0) \
                    if self._y4m_frame_prefix else 0
                n = (sz - base) // per
                fps = info.fps
                if fps.num:
                    return n * 1_000_000_000 * fps.denom // fps.num
            if self._audio_info is not None:
                n = sz // self._audio_info.bpf
                return n * 1_000_000_000 // self._audio_info.rate
        except (OSError, ValueError):
            pass
        return None

    def position_ns(self):
        if self._video_info is not None and self._video_info.fps.num:
            fps = self._video_info.fps
            return self._frame_idx * 1_000_000_000 * fps.denom // fps.num
        if self._audio_info is not None:
            return self._frame_idx * 1_000_000_000 // self._audio_info.rate
        return 0

    def get_caps(self, filter=None):
        if self._video_info is None and self._audio_info is None:
            try:
                self._sniff()
            except FileNotFoundError:
                pass
        if self._video_info is not None:
            caps = Caps([self._video_info.to_caps_structure()])
        elif self._audio_info is not None:
            caps = Caps([self._audio_info.to_caps_structure()])
        else:
            caps = Caps.any()
        if filter is not None:
            # ANY ∩ filter = filter (lets downstream parsers like
            # rawvideoparse pin the byte-stream caps)
            caps = filter if caps.is_any else caps.intersect(filter)
        if caps.is_any:
            # unknown content feeding a parser that accepts anything:
            # fixate to a plain byte stream so negotiation completes
            caps = Caps.from_string("application/octet-stream")
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._sniff()
        self._close_native()
        # the native mmap readers (native/gtpu_io.cpp) for y4m; without
        # g++ the Python reader below runs; a failing build or open raises
        if self._y4m_frame_prefix and native_io.available():
            self._native = [native_io.NativeY4MReader(self.props["location"])
                            for _ in range(self.READERS)]
            self._pool = ThreadPoolExecutor(max_workers=self.READERS)
        self._file = open(self.props["location"], "rb")
        if self._y4m_frame_prefix:
            self._file.seek(self._y4m_header_len)
        self._frame_idx = 0

    def _close_native(self):
        for r in self._native:
            r.close()
        self._native = []
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _read_native(self, out: np.ndarray) -> int:
        """Frames from ``_frame_idx`` on into `out` (n, frame_size), a
        contiguous share a reader; returns how many.  The file's frames
        are contiguous, so every share before a short one is full."""
        n = out.shape[0]
        per = -(-n // len(self._native))

        def share(k):
            lo = k * per
            if lo >= n:
                return 0
            reader = self._native[k]
            reader.seek(self._frame_idx + lo)
            return reader.read(out[lo:lo + per])
        return sum(self._pool.map(share, range(len(self._native))))

    def stop(self):
        self._close_native()
        if self._file:
            self._file.close()
            self._file = None

    def do_seek(self, segment) -> bool:
        if self._video_info is not None:
            fps = self._video_info.fps
            if not fps.num:
                return False
            frame = segment.start * fps.num // (1_000_000_000 * fps.denom)
            self._frame_idx = frame
            if self._file:
                fsz = frame_size(self._video_info.finfo,
                                 self._video_info.width,
                                 self._video_info.height)
                per = fsz + (6 if self._y4m_frame_prefix else 0)
                base = self._y4m_header_len if self._y4m_frame_prefix else 0
                self._file.seek(base + frame * per)
            return True
        if self._audio_info is not None:
            pos = segment.start * self._audio_info.rate // 1_000_000_000
            self._frame_idx = pos
            if self._file:
                self._file.seek(pos * self._audio_info.bpf)
            return True
        return False

    READERS = 4      # native readers of a y4m, one thread each

    # -- device-side plane split (ingest fast path) ------------------------
    _SPLITTABLE = ("I420", "YV12", "Y42B", "Y444", "GRAY8", "NV12")

    def generator_fn(self):
        """For plain planar formats the source emits the CONTIGUOUS raw
        frame bytes and the plane split happens on the device as tensor
        views: one host-to-device copy a tick instead of one per
        plane."""
        info = self._video_info
        if info is None and self.props["location"]:
            try:
                self._sniff()
            except FileNotFoundError:
                pass
            info = self._video_info
        if info is None or info.finfo.name not in self._SPLITTABLE:
            self._emit_raw = False
            return None
        w, h = info.width, info.height
        name = info.finfo.name
        self._emit_raw = True

        def split(raw):
            ys = w * h
            y = raw[:, :ys].reshape(-1, h, w)
            if name == "GRAY8":
                return (y,)
            if name in ("I420", "YV12"):
                cs = ys // 4
                a = raw[:, ys:ys + cs].reshape(-1, h // 2, w // 2)
                b = raw[:, ys + cs:ys + 2 * cs].reshape(
                    -1, h // 2, w // 2)
                return (y, a, b) if name == "I420" else (y, b, a)
            if name == "Y42B":
                cs = ys // 2
                a = raw[:, ys:ys + cs].reshape(-1, h, w // 2)
                b = raw[:, ys + cs:ys + 2 * cs].reshape(-1, h, w // 2)
                return (y, a, b)
            if name == "Y444":
                a = raw[:, ys:2 * ys].reshape(-1, h, w)
                b = raw[:, 2 * ys:3 * ys].reshape(-1, h, w)
                return (y, a, b)
            # NV12: interleaved UV plane
            uv = raw[:, ys:].reshape(-1, h // 2, w)
            return (y, uv)

        return split

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._video_info is not None:
            return self._create_video(n_frames)
        if self._audio_info is not None:
            return self._create_audio(n_frames)
        data = self._file.read(self.props["blocksize"] * n_frames)
        if not data:
            return None
        return Buffer(data=np.frombuffer(data, np.uint8), batch=1)

    def _create_video(self, n_frames):
        info = self._video_info
        fsz = frame_size(info.finfo, info.width, info.height)
        if self._native:
            # page-locked for a CUDA pipeline: the staging copy reads it
            # directly, and torch's host cache recycles it across ticks
            cuda = self.device is not None and self.device.type == "cuda"
            data_flat = (torch.empty((n_frames, fsz), dtype=torch.uint8,
                                     pin_memory=True) if cuda
                         else np.empty((n_frames, fsz), np.uint8))
            got = self._read_native(data_flat.numpy() if cuda
                                    else data_flat)
            if got == 0:
                return None
            data_flat = data_flat[:got]
            self.native_batches += 1
        else:
            frames = []
            for _ in range(n_frames):
                if self._y4m_frame_prefix:
                    line = self._file.readline()
                    if not line.startswith(b"FRAME"):
                        break
                raw = self._file.read(fsz)
                if len(raw) < fsz:
                    break
                frames.append(np.frombuffer(raw, np.uint8))
            if not frames:
                return None
            data_flat = np.stack(frames)
        n_got = data_flat.shape[0]
        if getattr(self, "_emit_raw", False):
            planes = data_flat
        else:
            planes = from_bytes(info.finfo, host_array(data_flat),
                                info.width, info.height)
        fps = info.fps
        pts = (self._frame_idx * 1_000_000_000 * fps.denom // fps.num
               if fps.num else 0)
        dur = 1_000_000_000 * fps.denom // fps.num if fps.num else None
        buf = Buffer(data=(planes if getattr(self, "_emit_raw", False)
                           else tuple(planes)),
                     pts=pts, duration=dur,
                     batch=n_got, offset=self._frame_idx)
        self._frame_idx += n_got
        return buf

    def _create_audio(self, n_frames):
        info = self._audio_info
        chunk = 4096 * max(1, n_frames) * info.bpf
        raw = self._file.read(chunk)
        if not raw:
            return None
        n = len(raw) // info.bpf
        samples = afmt.from_bytes(info.finfo,
                                  np.frombuffer(raw[:n * info.bpf], np.uint8),
                                  info.channels)
        pts = self._frame_idx * 1_000_000_000 // info.rate
        self._frame_idx += n
        return Buffer(data=samples, pts=pts,
                      duration=n * 1_000_000_000 // info.rate, batch=1)


@register_element
class FileSink(SinkElement):
    FACTORY = "filesink"
    DESCRIPTION = "Write stream to a file"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "file path"),
        "append": (bool, False, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._info = None

    def set_info(self, incaps, outcaps):
        if incaps is not None and len(incaps):
            s = incaps[0]
            if s.name == "video/x-raw":
                self._info = VideoInfo.from_caps_structure(s)
            elif s.name == "audio/x-raw":
                self._info = AudioInfo.from_caps_structure(s)

    def start(self):
        mode = "ab" if self.props["append"] else "wb"
        self._file = open(self.props["location"], mode)

    def stop(self):
        if self._file:
            self._file.close()
            self._file = None

    def render(self, buf: Buffer) -> str:
        if isinstance(self._info, VideoInfo):
            planes = tuple(host_array(p) for p in buf.data)
            raw = to_bytes(self._info.finfo, planes, self._info.width,
                           self._info.height)
            self._file.write(np.ascontiguousarray(raw).tobytes())
        elif isinstance(self._info, AudioInfo):
            raw = afmt.to_bytes(self._info.finfo, buf.data)
            self._file.write(raw.tobytes())
        else:
            self._file.write(host_array(buf.data).tobytes())
        return FlowReturn.OK


@register_element
class MultiFileSrc(FileSrc):
    """multifilesrc: location with %d index pattern, one frame per file.

    Without ``caps`` a tick of n files emits the n blobs as a list (one
    item an image; a single file as the array itself, as the reference
    does).  The reference emits only the first of the n files at batch > 1
    (ROADMAP.md section 3)."""
    FACTORY = "multifilesrc"
    DESCRIPTION = "Read a sequentially named set of files"
    PROPERTIES = dict(FileSrc.PROPERTIES, **{
        "index": (int, 0, "start index"),
        "stop-index": (int, -1, "stop index (-1 = until missing)"),
    })

    def start(self):
        self._frame_idx = 0
        self._index = self.props["index"]
        caps = self.props["caps"]
        if caps is not None:
            s = caps[0]
            if s.name == "video/x-raw":
                self._video_info = VideoInfo.from_caps_structure(s)

    def stop(self):
        pass

    def create(self, n_frames: int) -> Optional[Buffer]:
        info = self._video_info
        frames = []
        for _ in range(n_frames):
            stop = self.props["stop-index"]
            if stop >= 0 and self._index > stop:
                break
            path = self.props["location"] % self._index
            if not os.path.exists(path):
                break
            with open(path, "rb") as f:
                frames.append(np.frombuffer(f.read(), np.uint8))
            self._index += 1
        if not frames:
            return None
        if info is not None:
            data = from_bytes(info.finfo, np.stack(frames), info.width,
                              info.height)
            fps = info.fps
            pts = (self._frame_idx * 1_000_000_000 * fps.denom // fps.num
                   if fps.num else 0)
            buf = Buffer(data=tuple(data), pts=pts, batch=len(frames))
        elif len(frames) == 1:
            buf = Buffer(data=frames[0], batch=1)
        else:
            buf = Buffer(data=frames, batch=len(frames))
        self._frame_idx += len(frames)
        return buf


@register_element
class MultiFileSink(SinkElement):
    FACTORY = "multifilesink"
    DESCRIPTION = "Write buffers to sequentially named files"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {"location": (str, "frame%05d.raw", "")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._index = 0
        self._info = None

    def set_info(self, incaps, outcaps):
        if incaps is not None and len(incaps) and incaps[0].name == "video/x-raw":
            self._info = VideoInfo.from_caps_structure(incaps[0])

    def render(self, buf: Buffer) -> str:
        if self._info is not None:
            planes = tuple(host_array(p) for p in buf.data)
            raw = to_bytes(self._info.finfo, planes, self._info.width,
                           self._info.height)
            raw = raw.reshape(buf.batch, -1)
            for i in range(buf.batch):
                with open(self.props["location"] % self._index, "wb") as f:
                    f.write(raw[i].tobytes())
                self._index += 1
        elif isinstance(buf.data, list):
            # packetized payloads (encoded images): one file per item
            for item in buf.data:
                blob = item if isinstance(item, (bytes, bytearray)) \
                    else host_array(item).tobytes()
                with open(self.props["location"] % self._index, "wb") as f:
                    f.write(blob)
                self._index += 1
        else:
            with open(self.props["location"] % self._index, "wb") as f:
                f.write(host_array(buf.data).tobytes())
            self._index += 1
        return FlowReturn.OK


@register_element
class Y4mEnc(SinkElement):
    """y4menc+filesink fused: writes a YUV4MPEG2 stream.

    Reference: subprojects/gst-plugins-good/gst/y4m/gsty4menc.c —
    stream header "YUV4MPEG2 C%s W%d H%d I%c F%d:%d A%d:%d\\n" (:192),
    per-frame "FRAME\\n" (:215); chroma tags per gsty4mformat.c
    ChromaSubsamplingMap (:166)."""
    FACTORY = "y4menc"
    DESCRIPTION = "Encodes video into the YUV4MPEG2 stream format"
    PAD_TEMPLATES = [PadTemplate(
        "sink", PadDirection.SINK,
        "video/x-raw, format={ I420, Y42B, Y444, GRAY8 }, "
        "width=[1,32767], height=[1,32767], "
        "framerate=[0/1,2147483647/1]")]
    PROPERTIES = {"location": (str, "out.y4m", "output path")}

    _TAGS = {"I420": "420jpeg", "Y42B": "422", "Y444": "444",
             "GRAY8": "mono"}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._info = None

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def start(self):
        self._file = open(self.props["location"], "wb")
        info = self._info
        # 420jpeg for interstitial siting, 420mpeg2 for H-cosited
        tag = self._TAGS[info.format]
        if info.format == "I420" and info.chroma_site == "mpeg2":
            tag = "420mpeg2"
        fps = info.fps
        hdr = (f"YUV4MPEG2 C{tag} W{info.width} H{info.height} Ip "
               f"F{fps.num}:{fps.denom} "
               f"A{info.par.num}:{info.par.denom}\n")
        self._file.write(hdr.encode())

    def stop(self):
        if self._file:
            self._file.close()
            self._file = None

    def render(self, buf: Buffer) -> str:
        info = self._info
        planes = [host_array(p) for p in buf.data]
        n = planes[0].shape[0]
        for k in range(n):
            self._file.write(b"FRAME\n")
            tight = to_bytes(info.finfo, [p[k] for p in planes],
                             info.width, info.height)
            self._file.write(tight.tobytes())
        return FlowReturn.OK


@register_element
class DataUriSrc(SourceElement):
    """dataurisrc (gstdataurisrc.c): decodes a data: URI into one buffer."""
    FACTORY = "dataurisrc"
    DESCRIPTION = "Handles data: uris"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"uri": (str, "", "data:[<mediatype>][;base64],<data>")}

    def get_caps(self, filter=None):
        caps = Caps.from_string("application/octet-stream")
        if filter is not None and not filter.is_any \
                and caps.can_intersect(filter):
            caps = caps.intersect(filter)
        return caps

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sent = False

    def _decode(self) -> bytes:
        import base64
        import urllib.parse
        uri = self.props["uri"]
        if not uri.startswith("data:"):
            raise ValueError(f"dataurisrc: not a data uri: {uri!r}")
        header, _, payload = uri[5:].partition(",")
        if header.endswith(";base64"):
            return base64.b64decode(payload)
        return urllib.parse.unquote_to_bytes(payload)

    def start(self):
        self._sent = False

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._sent:
            return None
        self._sent = True
        return Buffer(data=np.frombuffer(self._decode(), np.uint8), batch=1)


@register_element
class FdSrc(SourceElement):
    """fdsrc (gstfdsrc.c): reads byte buffers from a file descriptor."""
    FACTORY = "fdsrc"
    DESCRIPTION = "Read from a file descriptor"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"fd": (int, 0, "file descriptor"),
                  "blocksize": (int, 4096, "bytes per buffer")}

    def get_caps(self, filter=None):
        caps = Caps.from_string("application/octet-stream")
        if filter is not None and not filter.is_any \
                and caps.can_intersect(filter):
            caps = caps.intersect(filter)
        return caps

    def create(self, n_frames: int) -> Optional[Buffer]:
        data = os.read(self.props["fd"],
                       self.props["blocksize"] * max(n_frames, 1))
        if not data:
            return None
        return Buffer(data=np.frombuffer(data, np.uint8), batch=1)


@register_element
class FdSink(SinkElement):
    """fdsink (gstfdsink.c): writes raw bytes to a file descriptor."""
    FACTORY = "fdsink"
    DESCRIPTION = "Write to a file descriptor"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {"fd": (int, 1, "file descriptor")}

    def render(self, buf: Buffer) -> str:
        data = buf.data
        leaves = data if isinstance(data, (tuple, list)) else (data,)
        for leaf in leaves:
            os.write(self.props["fd"], host_array(leaf).tobytes())
        return FlowReturn.OK


@register_element
class GioSrc(FileSrc):
    """giosrc (gst-plugins-base/gst/gio/gstgiosrc.c capability): reads
    from a GIO-style URI.  Reduced to the local schemes that exist in
    this environment (file://, data:)."""
    FACTORY = "giosrc"
    DESCRIPTION = "Read from any GIO-supported location"

    def __init__(self, name=None, **props):
        loc = props.get("location", "")
        if loc.startswith("file://"):
            props["location"] = loc[len("file://"):]
        elif loc.startswith("data:"):
            raise ValueError("giosrc: use dataurisrc for data: URIs")
        super().__init__(name=name, **props)


@register_element
class GioSink(FileSink):
    """giosink (gstgiosink.c capability, file:// scheme)."""
    FACTORY = "giosink"
    DESCRIPTION = "Write to any GIO-supported location"

    def __init__(self, name=None, **props):
        loc = props.get("location", "")
        if loc.startswith("file://"):
            props["location"] = loc[len("file://"):]
        super().__init__(name=name, **props)
