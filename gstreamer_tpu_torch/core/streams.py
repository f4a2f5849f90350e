"""Stream descriptions, collections, TOC, URI handling, and contexts.

TPU-native equivalents of the remaining core utility types
(reference: subprojects/gstreamer/gst/):

* GstStream / GstStreamCollection (gststreams.c, gststreamcollection.c)
  — typed stream descriptors published by parsers/demuxers;
* GstToc / GstTocEntry (gsttoc.c) — table of contents (chapters);
* gst_uri_* (gsturi.c:3080) — URI parsing and the URI-handler registry
  that backs uridecodebin-style source selection;
* GstContext (gstcontext.c) — shared contexts distributed to elements.

A copy of the JAX package's ``core/streams.py``.
"""

from __future__ import annotations

import os
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .caps import Caps
from .tags import TagList


class StreamType:
    """GstStreamType flags."""
    UNKNOWN = 0
    AUDIO = 1 << 0
    VIDEO = 1 << 1
    CONTAINER = 1 << 2
    TEXT = 1 << 3


@dataclass
class Stream:
    """GstStream: immutable-ish stream descriptor."""
    stream_id: str
    caps: Optional[Caps] = None
    stream_type: int = StreamType.UNKNOWN
    flags: int = 0
    tags: Optional[TagList] = None

    def __repr__(self):
        return f"<Stream {self.stream_id} type={self.stream_type}>"


class StreamCollection:
    """GstStreamCollection: ordered set of streams for one upstream id."""

    def __init__(self, upstream_id: str = ""):
        self.upstream_id = upstream_id
        self._streams: List[Stream] = []

    def add_stream(self, stream: Stream) -> None:
        self._streams.append(stream)

    def get_size(self) -> int:
        return len(self._streams)

    def get_stream(self, index: int) -> Stream:
        return self._streams[index]

    def __iter__(self):
        return iter(self._streams)


# ---------------------------------------------------------------------------
# TOC (gsttoc.c)
# ---------------------------------------------------------------------------

class TocEntryType:
    CHAPTER = "chapter"
    EDITION = "edition"
    ANGLE = "angle"
    VERSION = "version"
    TRACK = "track"
    TITLE = "title"


@dataclass
class TocEntry:
    entry_type: str
    uid: str
    start: Optional[int] = None         # ns
    stop: Optional[int] = None
    tags: Optional[TagList] = None
    subentries: List["TocEntry"] = field(default_factory=list)

    def append_sub_entry(self, e: "TocEntry") -> None:
        self.subentries.append(e)


@dataclass
class Toc:
    scope: str = "global"               # global | current
    entries: List[TocEntry] = field(default_factory=list)
    tags: Optional[TagList] = None

    def append_entry(self, e: TocEntry) -> None:
        self.entries.append(e)

    def find_entry(self, uid: str) -> Optional[TocEntry]:
        def walk(entries):
            for e in entries:
                if e.uid == uid:
                    return e
                r = walk(e.subentries)
                if r is not None:
                    return r
            return None
        return walk(self.entries)


# ---------------------------------------------------------------------------
# URI handling (gsturi.c)
# ---------------------------------------------------------------------------

_URI_HANDLERS: Dict[str, str] = {
    # protocol -> source factory (gst_element_make_from_uri registry)
    "file": "filesrc",
    "tcp": "tcpclientsrc",
    "udp": "udpsrc",
    "appsrc": "appsrc",
}


def uri_is_valid(uri: str) -> bool:
    p = urllib.parse.urlparse(uri)
    return bool(p.scheme) and (bool(p.netloc) or bool(p.path))


def uri_get_protocol(uri: str) -> str:
    return urllib.parse.urlparse(uri).scheme


def uri_get_location(uri: str) -> str:
    p = urllib.parse.urlparse(uri)
    if p.scheme == "file":
        return urllib.parse.unquote(p.path)
    loc = p.netloc + p.path
    return urllib.parse.unquote(loc)


def filename_to_uri(path: str) -> str:
    return "file://" + urllib.parse.quote(os.path.abspath(path))


def register_uri_handler(protocol: str, factory: str) -> None:
    _URI_HANDLERS[protocol] = factory


def element_make_from_uri(uri: str, name: Optional[str] = None):
    """gst_element_make_from_uri: build + configure a source for `uri`."""
    from .element import element_factory_make

    proto = uri_get_protocol(uri)
    factory = _URI_HANDLERS.get(proto)
    if factory is None:
        raise ValueError(f"no URI handler for protocol {proto!r}")
    e = element_factory_make(factory, name=name)
    loc = uri_get_location(uri)
    if "location" in e.PROPERTIES:
        e.set_property("location", loc)
    elif "host" in e.PROPERTIES:
        p = urllib.parse.urlparse(uri)
        if p.hostname:
            e.set_property("host", p.hostname)
        if p.port:
            e.set_property("port", p.port)
    return e


# ---------------------------------------------------------------------------
# Contexts (gstcontext.c)
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """GstContext: a named, persistent bag of values shared with
    elements (device handles, display connections...)."""
    context_type: str
    persistent: bool = True
    values: Dict[str, Any] = field(default_factory=dict)


class ContextRegistry:
    """Pipeline-level context store: elements query by type
    (gst_element_set_context distribution)."""

    def __init__(self):
        self._contexts: Dict[str, Context] = {}

    def set_context(self, ctx: Context) -> None:
        self._contexts[ctx.context_type] = ctx

    def get_context(self, context_type: str) -> Optional[Context]:
        return self._contexts.get(context_type)
