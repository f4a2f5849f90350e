"""Tag writers: TagList -> ID3v2 / VorbisComment / Exif / XMP.

The write-side complement of tagreaders.py, mirroring the reference
tag library's serializers (subprojects/gst-plugins-base/gst-libs/gst/
tag/ — id3v2 writing in gsttagmux users, gstvorbistag.c
gst_tag_list_to_vorbiscomment_buffer, gstexiftag.c
gst_tag_list_to_exif_buffer, gstxmptag.c gst_tag_list_to_xmp_buffer).
Every writer has a matching reader here or in tagreaders.py and tests
assert lossless roundtrips for the supported tag set.

A copy of the JAX package's ``utils/tagwriters.py`` (host only).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..core.tags import TagList
from .tagreaders import _ID3_FRAMES, _VORBIS_FIELDS

# reverse maps (first spelling wins)
_TAG_TO_ID3 = {}
for _fid, _tag in _ID3_FRAMES.items():
    _TAG_TO_ID3.setdefault(_tag, _fid)
_TAG_TO_ID3["date"] = b"TDRC"            # write the v2.4 frame

_TAG_TO_VORBIS = {}
for _field, _tag in _VORBIS_FIELDS.items():
    _TAG_TO_VORBIS.setdefault(_tag, _field)
_TAG_TO_VORBIS["comment"] = "COMMENT"


def _syncsafe_bytes(n: int) -> bytes:
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F,
                  (n >> 7) & 0x7F, n & 0x7F])


def write_id3v2(tags: TagList, version: int = 4) -> bytes:
    """Serialize a TagList as an ID3v2.3/2.4 tag block."""
    frames = b""
    for tag, values in tags._tags.items():
        fid = _TAG_TO_ID3.get(tag)
        if fid is None:
            continue
        if version == 3 and fid == b"TDRC":
            fid = b"TYER"
        for v in values:
            if fid == b"COMM":
                # enc + lang + empty short-description + text
                body = b"\x03eng\x00" + str(v).encode("utf-8")
            else:
                body = b"\x03" + str(v).encode("utf-8")
            size = (_syncsafe_bytes(len(body)) if version >= 4
                    else struct.pack(">I", len(body)))
            frames += fid + size + b"\x00\x00" + body
    header = (b"ID3" + bytes([version, 0, 0])
              + _syncsafe_bytes(len(frames)))
    return header + frames


def write_vorbis_comment(tags: TagList,
                         vendor: str = "gstreamer_tpu") -> bytes:
    """gst_tag_list_to_vorbiscomment_buffer (gstvorbistag.c) without
    the framing byte: vendor + field list."""
    out = struct.pack("<I", len(vendor.encode())) + vendor.encode()
    fields = []
    for tag, values in tags._tags.items():
        key = _TAG_TO_VORBIS.get(tag)
        if key is None:
            continue
        for v in values:
            fields.append(f"{key}={v}".encode("utf-8"))
    out += struct.pack("<I", len(fields))
    for f in fields:
        out += struct.pack("<I", len(f)) + f
    return out


# ------------------------------------------------------------------ Exif

# tag name -> (IFD0 tag id, type)  type 2 = ASCII
_EXIF_TAGS = {
    "description": (0x010E, 2),
    "device-manufacturer": (0x010F, 2),
    "device-model": (0x0110, 2),
    "artist": (0x013B, 2),
    "copyright": (0x8298, 2),
    "application-name": (0x0131, 2),     # Software
    "datetime": (0x0132, 2),
    "image-orientation": (0x0112, 3),    # SHORT
}
_EXIF_REV = {tid: (name, typ) for name, (tid, typ) in _EXIF_TAGS.items()}

_ORIENTATIONS = ["rotate-0", "flip-rotate-0", "rotate-180",
                 "flip-rotate-180", "flip-rotate-270", "rotate-90",
                 "flip-rotate-90", "rotate-270"]


def write_exif(tags: TagList, byte_order: str = "<") -> bytes:
    """TagList -> TIFF/Exif blob (IFD0 with ASCII/SHORT entries;
    gstexiftag.c gst_tag_list_to_exif_buffer layout)."""
    entries = []     # (tag_id, type, count, inline_value_or_data)
    for tag, values in tags._tags.items():
        if tag not in _EXIF_TAGS or not values:
            continue
        tid, typ = _EXIF_TAGS[tag]
        v = values[0]
        if typ == 2:
            data = str(v).encode("utf-8") + b"\x00"
            entries.append((tid, 2, len(data), data))
        else:
            if tag == "image-orientation":
                try:
                    v = _ORIENTATIONS.index(str(v)) + 1
                except ValueError:
                    v = 1
            entries.append((tid, 3, 1,
                            struct.pack(byte_order + "H", int(v))
                            + b"\x00\x00"))
    entries.sort(key=lambda e: e[0])
    bo = byte_order
    header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "H", 42) \
        + struct.pack(bo + "I", 8)
    ifd_off = 8
    data_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd = struct.pack(bo + "H", len(entries))
    tail = b""
    for tid, typ, count, data in entries:
        if len(data) <= 4:
            value = data + b"\x00" * (4 - len(data))
        else:
            value = struct.pack(bo + "I", data_off + len(tail))
            tail += data + (b"\x00" if len(data) % 2 else b"")
        ifd += struct.pack(bo + "HHI", tid, typ, count) + value
    ifd += struct.pack(bo + "I", 0)          # next IFD
    return header + ifd + tail


def parse_exif(data: bytes) -> Optional[TagList]:
    """TIFF/Exif blob -> TagList (reader side for roundtrips)."""
    if len(data) < 8 or data[:2] not in (b"II", b"MM"):
        return None
    bo = "<" if data[:2] == b"II" else ">"
    if struct.unpack(bo + "H", data[2:4])[0] != 42:
        return None
    ifd_off = struct.unpack(bo + "I", data[4:8])[0]
    try:
        n = struct.unpack(bo + "H", data[ifd_off:ifd_off + 2])[0]
        tags = TagList()
        for i in range(n):
            off = ifd_off + 2 + 12 * i
            tid, typ, count = struct.unpack(bo + "HHI",
                                            data[off:off + 8])
            value = data[off + 8:off + 12]
            name_typ = _EXIF_REV.get(tid)
            if name_typ is None:
                continue
            name, _ = name_typ
            if typ == 2:
                if count > 4:
                    voff = struct.unpack(bo + "I", value)[0]
                    raw = data[voff:voff + count]
                else:
                    raw = value[:count]
                text = raw.rstrip(b"\x00").decode("utf-8", "replace")
                if text:
                    tags.add("append", name, text)
            elif typ == 3:
                v = struct.unpack(bo + "H", value[:2])[0]
                if name == "image-orientation":
                    if 1 <= v <= 8:
                        tags.add("append", name, _ORIENTATIONS[v - 1])
                else:
                    tags.add("append", name, v)
        return tags
    except (struct.error, IndexError):
        return None


# ------------------------------------------------------------------- XMP

_XMP_FIELDS = {
    "title": ("dc:title", True),          # (qname, uses rdf:Alt)
    "artist": ("dc:creator", False),      # rdf:Seq
    "copyright": ("dc:rights", True),
    "description": ("dc:description", True),
    "keywords": ("dc:subject", False),
    "application-name": ("xmp:CreatorTool", None),   # simple
    "date": ("xmp:CreateDate", None),
}
_XMP_REV = {q: (name, kind) for name, (q, kind) in _XMP_FIELDS.items()}


def write_xmp(tags: TagList) -> bytes:
    """TagList -> XMP packet (gstxmptag.c
    gst_tag_list_to_xmp_buffer, RDF/XML with the dc/xmp schemas)."""
    props = []
    for tag, values in tags._tags.items():
        if tag not in _XMP_FIELDS or not values:
            continue
        qname, kind = _XMP_FIELDS[tag]
        esc = [str(v).replace("&", "&amp;").replace("<", "&lt;")
               for v in values]
        if kind is None:
            props.append(f"<{qname}>{esc[0]}</{qname}>")
        elif kind:                                   # rdf:Alt
            props.append(
                f"<{qname}><rdf:Alt><rdf:li xml:lang=\"x-default\">"
                f"{esc[0]}</rdf:li></rdf:Alt></{qname}>")
        else:                                        # rdf:Seq/Bag
            lis = "".join(f"<rdf:li>{v}</rdf:li>" for v in esc)
            props.append(f"<{qname}><rdf:Seq>{lis}</rdf:Seq></{qname}>")
    body = (
        '<?xpacket begin="﻿" id="W5M0MpCehiHzreSzNTczkc9d"?>\n'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/">\n'
        '<rdf:RDF xmlns:rdf='
        '"http://www.w3.org/1999/02/22-rdf-syntax-ns#">\n'
        '<rdf:Description rdf:about="" '
        'xmlns:dc="http://purl.org/dc/elements/1.1/" '
        'xmlns:xmp="http://ns.adobe.com/xap/1.0/">\n'
        + "\n".join(props)
        + "\n</rdf:Description>\n</rdf:RDF>\n</x:xmpmeta>\n"
        '<?xpacket end="w"?>')
    return body.encode("utf-8")


def parse_xmp(data: bytes) -> Optional[TagList]:
    """XMP packet -> TagList (regex-free scan good enough for the
    writer's own output and common producers)."""
    try:
        text = data.decode("utf-8", "replace")
    except Exception:
        return None
    if "xmpmeta" not in text:
        return None
    import re
    tags = TagList()
    for qname, (name, kind) in _XMP_REV.items():
        pat = re.compile(
            rf"<{re.escape(qname)}[^>]*>(.*?)</{re.escape(qname)}>",
            re.S)
        m = pat.search(text)
        if not m:
            continue
        inner = m.group(1)
        lis = re.findall(r"<rdf:li[^>]*>(.*?)</rdf:li>", inner, re.S)
        values = lis if lis else [inner]
        for v in values:
            v = v.strip().replace("&lt;", "<").replace("&amp;", "&")
            if v:
                tags.add("append", name, v)
    return tags
