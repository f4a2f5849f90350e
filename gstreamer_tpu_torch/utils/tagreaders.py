"""Tag readers: ID3v2 and VorbisComment -> TagList.

TPU-native slice of the reference tag library
(subprojects/gst-plugins-base/gst-libs/gst/tag/ — gstid3tag.c frame
table, gstvorbistag.c comment mapping).  Parses the two dominant
metadata containers into the core TagList (core/tags.py).

A copy of the JAX package's ``utils/tagreaders.py`` (host only).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..core.tags import TagList

# ID3v2 frame id -> tag name (gstid3tag.c tag_matches table, subset)
_ID3_FRAMES = {
    b"TIT2": "title",
    b"TPE1": "artist",
    b"TALB": "album",
    b"TDRC": "date",
    b"TYER": "date",
    b"TRCK": "track-number",
    b"TCON": "genre",
    b"COMM": "comment",
    b"TCOM": "composer",
    b"TPE2": "album-artist",
    b"TPOS": "album-disc-number",
    b"TBPM": "beats-per-minute",
    b"TCOP": "copyright",
    b"TENC": "encoded-by",
    b"TSSE": "encoder",
}

_ENCODINGS = {0: "latin-1", 1: "utf-16", 2: "utf-16-be", 3: "utf-8"}


def _syncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def parse_id3v2(data: bytes) -> Optional[TagList]:
    """Parse an ID3v2.3/2.4 tag block (gstid3tag.c semantics)."""
    if len(data) < 10 or data[:3] != b"ID3":
        return None
    version = data[3]
    size = _syncsafe(data[6:10])
    tags = TagList()
    pos = 10
    end = min(10 + size, len(data))
    while pos + 10 <= end:
        fid = data[pos:pos + 4]
        if fid == b"\x00\x00\x00\x00":
            break
        if version >= 4:
            fsize = _syncsafe(data[pos + 4:pos + 8])
        else:
            fsize = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 10:pos + 10 + fsize]
        pos += 10 + fsize
        tag = _ID3_FRAMES.get(fid)
        if tag is None or not body:
            continue
        enc = _ENCODINGS.get(body[0], "latin-1")
        if fid == b"COMM" and len(body) > 4:
            body = body[4:]          # language code
            text = body.split(b"\x00", 1)[-1]
        else:
            text = body[1:]
        try:
            value = text.decode(enc).strip("\x00").strip()
        except UnicodeDecodeError:
            continue
        if not value:
            continue
        if tag in ("track-number", "album-disc-number"):
            value = value.split("/")[0]
            try:
                value = int(value)
            except ValueError:
                continue
        tags.add("append", tag, value)
    return tags


# vorbiscomment field -> tag (gstvorbistag.c tag_matches, subset)
_VORBIS_FIELDS = {
    "TITLE": "title",
    "ARTIST": "artist",
    "ALBUM": "album",
    "DATE": "date",
    "TRACKNUMBER": "track-number",
    "GENRE": "genre",
    "COMMENT": "comment",
    "DESCRIPTION": "comment",
    "COMPOSER": "composer",
    "ALBUMARTIST": "album-artist",
    "ENCODER": "encoder",
    "ORGANIZATION": "organization",
    "LOCATION": "geo-location-name",
    "ISRC": "isrc",
}


def parse_vorbis_comment(data: bytes) -> Optional[TagList]:
    """Parse a VorbisComment block (vendor string + field list)."""
    try:
        pos = 0
        vlen = struct.unpack("<I", data[pos:pos + 4])[0]
        pos += 4 + vlen
        n = struct.unpack("<I", data[pos:pos + 4])[0]
        pos += 4
        tags = TagList()
        for _ in range(n):
            flen = struct.unpack("<I", data[pos:pos + 4])[0]
            pos += 4
            field = data[pos:pos + flen].decode("utf-8")
            pos += flen
            if "=" not in field:
                continue
            key, value = field.split("=", 1)
            tag = _VORBIS_FIELDS.get(key.upper())
            if tag is None or not value:
                continue
            if tag == "track-number":
                try:
                    value = int(value)
                except ValueError:
                    continue
            tags.add("append", tag, value)
        return tags
    except (struct.error, IndexError, UnicodeDecodeError):
        return None
