"""Tag lists and promises — GstTagList / GstPromise equivalents.

A copy of the JAX package's ``core/tags.py``.

Reference: subprojects/gstreamer/gst/gsttaglist.c (2238 LoC — typed tag
registry with merge functions and merge modes gst_tag_list_merge :667),
gstpromise.c (reply/interrupt/expire state machine).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

# merge modes (GstTagMergeMode, gsttaglist.h)
MERGE_REPLACE_ALL = "replace-all"
MERGE_REPLACE = "replace"
MERGE_APPEND = "append"
MERGE_PREPEND = "prepend"
MERGE_KEEP = "keep"
MERGE_KEEP_ALL = "keep-all"

# a few standard tags with their multiplicity (single-valued tags replace)
_SINGLE = {"title", "artist", "album", "duration", "bitrate",
           "audio-codec", "video-codec", "container-format", "comment"}


class TagList:
    """dict-of-lists with GStreamer merge semantics."""

    def __init__(self, **tags):
        self._tags: Dict[str, List[Any]] = {}
        for k, v in tags.items():
            self.add(MERGE_APPEND, k.replace("_", "-"), v)

    def add(self, mode: str, tag: str, *values):
        cur = self._tags.setdefault(tag, [])
        vals = list(values)
        if mode == MERGE_REPLACE:
            self._tags[tag] = vals[:1] if tag in _SINGLE else vals
        elif mode == MERGE_PREPEND:
            self._tags[tag] = (vals[:1] if tag in _SINGLE
                               else vals + cur)
        elif mode == MERGE_KEEP:
            if not cur:
                self._tags[tag] = vals[:1] if tag in _SINGLE else vals
        else:  # append: fixed (single-valued) tags keep the existing
            if tag in _SINGLE:
                if not cur:
                    self._tags[tag] = vals[:1]
            else:
                cur.extend(vals)

    def get(self, tag: str) -> Optional[Any]:
        v = self._tags.get(tag)
        return v[0] if v else None

    def get_all(self, tag: str) -> List[Any]:
        return list(self._tags.get(tag, ()))

    def n_tags(self) -> int:
        return len(self._tags)

    def merge(self, other: "TagList", mode: str = MERGE_APPEND) -> "TagList":
        """gst_tag_list_merge (:667)."""
        out = TagList()
        if mode == MERGE_REPLACE_ALL:
            out._tags = {k: list(v) for k, v in other._tags.items()}
            return out
        if mode == MERGE_KEEP_ALL:
            out._tags = {k: list(v) for k, v in self._tags.items()}
            return out
        out._tags = {k: list(v) for k, v in self._tags.items()}
        for k, vals in other._tags.items():
            out.add(mode, k, *vals)
        return out

    def __contains__(self, tag):
        return tag in self._tags

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self._tags.items())
        return f"taglist({inner})"


class Promise:
    """gst_promise: single-assignment reply with wait/interrupt/expire."""

    PENDING = "pending"
    REPLIED = "replied"
    INTERRUPTED = "interrupted"
    EXPIRED = "expired"

    def __init__(self):
        self._cv = threading.Condition()
        self.result = self.PENDING
        self._reply: Any = None

    def reply(self, value: Any = None) -> None:
        with self._cv:
            if self.result != self.PENDING:
                return
            self.result = self.REPLIED
            self._reply = value
            self._cv.notify_all()

    def interrupt(self) -> None:
        with self._cv:
            if self.result == self.PENDING:
                self.result = self.INTERRUPTED
                self._cv.notify_all()

    def expire(self) -> None:
        with self._cv:
            if self.result == self.PENDING:
                self.result = self.EXPIRED
                self._cv.notify_all()

    def wait(self, timeout: Optional[float] = None) -> str:
        with self._cv:
            if self.result == self.PENDING:
                self._cv.wait(timeout)
            return self.result

    def get_reply(self) -> Any:
        return self._reply
