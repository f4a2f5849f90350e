"""Typefinding — content sniffing.

Reference: subprojects/gst-plugins-base/gst/typefind/
gsttypefindfunctions.c (7363 LoC, ~100 formats).  Table-driven magic
signatures plus the heuristic detectors that need real logic (MPEG
TS/PS sync scans, MP3 framesync, AC3/DTS sync words, H.264/H.265
byte-streams, QuickTime brand mapping, EBML doctype, text).

Probabilities mirror GST_TYPE_FIND_* (gsttypefind.h).

A copy of the JAX package's ``utils/typefind.py`` (host only).  Every
factory its ``DECODABLE`` routes name is ported; ``elements/playback.py``
raises for one that is not registered.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, List, Optional, Tuple

CERTAIN = 100
ALMOST_CERTAIN = 95
VERY_LIKELY = 90
LIKELY = 80
POSSIBLE = 50
MINIMUM = 1


def _magic(offset: int, sig: bytes, media: str, prob: int = CERTAIN):
    def find(head: bytes):
        if head[offset:offset + len(sig)] == sig:
            return media, prob
        return None
    return find


def _riff(fourcc: bytes, media: str):
    def find(head: bytes):
        if head[:4] == b"RIFF" and head[8:12] == fourcc:
            return media, CERTAIN
        return None
    return find


def _ebml(head: bytes):
    """Matroska/WebM: EBML header, doctype string distinguishes."""
    if not head.startswith(b"\x1a\x45\xdf\xa3"):
        return None
    window = head[:256]
    if b"webm" in window:
        return "video/webm", CERTAIN
    return "video/x-matroska", CERTAIN


def _qt(head: bytes):
    """ISO BMFF: ftyp brand decides the concrete caps
    (gsttypefindfunctions.c qt_type_find brand table)."""
    if len(head) < 12 or head[4:8] != b"ftyp":
        return None
    brand = head[8:12]
    if brand in (b"isom", b"iso2", b"mp41", b"mp42", b"mp4v", b"avc1",
                 b"dash", b"cmfc", b"av01"):
        return "video/quicktime, variant=(string)iso", CERTAIN
    if brand == b"M4A ":
        return "audio/x-m4a", CERTAIN
    if brand == b"M4V ":
        return "video/x-m4v", CERTAIN
    if brand == b"3gp4" or brand[:3] == b"3gp":
        return "video/quicktime, variant=(string)3gpp", CERTAIN
    if brand == b"qt  ":
        return "video/quicktime", CERTAIN
    if brand == b"heic" or brand == b"mif1":
        return "image/heif", CERTAIN
    if brand == b"avif":
        return "image/avif", CERTAIN
    return "video/quicktime", LIKELY


def _mpeg_ts(head: bytes):
    """MPEG-TS: 0x47 sync byte every 188 (or 192/204/208) bytes."""
    for pkt in (188, 192, 204, 208):
        off = 4 if pkt == 192 else 0
        n = min(5, (len(head) - off) // pkt)
        if n >= 3 and all(head[off + i * pkt] == 0x47 for i in range(n)):
            return (f"video/mpegts, systemstream=(boolean)true, "
                    f"packetsize=(int){pkt}", VERY_LIKELY)
    return None


def _mpeg_ps(head: bytes):
    if head.startswith(b"\x00\x00\x01\xba"):
        return "video/mpeg, systemstream=(boolean)true", ALMOST_CERTAIN
    return None


def _mpeg_video(head: bytes):
    if head.startswith(b"\x00\x00\x01\xb3"):
        return ("video/mpeg, systemstream=(boolean)false, "
                "mpegversion=(int)1"), ALMOST_CERTAIN
    return None


def _h26x(head: bytes):
    """H.264/H.265 byte-stream: start code + NAL type."""
    for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
        if head.startswith(sc) and len(head) > len(sc):
            b0 = head[len(sc)]
            if b0 >> 7:
                return None                      # forbidden_zero_bit
            h265_nal = (b0 >> 1) & 0x3F
            if h265_nal in (32, 33, 34):         # VPS/SPS/PPS
                return ("video/x-h265, stream-format=(string)"
                        "byte-stream"), LIKELY
            h264_nal = b0 & 0x1F
            if h264_nal in (7, 8, 5, 1, 9):      # SPS/PPS/IDR/slice/AUD
                return ("video/x-h264, stream-format=(string)"
                        "byte-stream"), LIKELY
    return None


def _mp3(head: bytes):
    if len(head) >= 4 and head[0] == 0xFF and (head[1] & 0xE6) >= 0xE2:
        layer = 4 - ((head[1] >> 1) & 0x3)
        if layer in (1, 2, 3):
            return (f"audio/mpeg, mpegversion=(int)1, layer=(int){layer}",
                    POSSIBLE)
    return None


def _ac3(head: bytes):
    if head[:2] == b"\x0b\x77":
        return "audio/x-ac3", POSSIBLE
    return None


def _dts(head: bytes):
    if head[:4] in (b"\x7f\xfe\x80\x01", b"\xfe\x7f\x01\x80"):
        return "audio/x-dts", VERY_LIKELY
    return None


def _aac_adts(head: bytes):
    if len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xF6) == 0xF0:
        return "audio/mpeg, mpegversion=(int)4, framed=(boolean)false", \
            POSSIBLE
    return None


def _id3v2(head: bytes):
    """id3v2_type_find: skip the tag and sniff the payload behind it
    (the reference recurses with the tag stripped)."""
    if not head.startswith(b"ID3"):
        return None
    if len(head) < 10:
        return ("audio/mpeg, mpegversion=(int)1, layer=(int)3",
                LIKELY)
    size = ((head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
            | (head[8] & 0x7F) << 7 | (head[9] & 0x7F))
    inner = head[10 + size:]
    if len(inner) >= 4:
        media, prob = type_find_data(inner)
        if prob > MINIMUM:
            return media, min(prob, ALMOST_CERTAIN)
    # tag present but payload out of reach: assume mp3 like players do
    return "audio/mpeg, mpegversion=(int)1, layer=(int)3", LIKELY


def _apetag(head: bytes):
    """apetag at stream start: skip and re-sniff."""
    if not head.startswith(b"APETAGEX") or len(head) < 32:
        return None
    size = struct.unpack("<I", head[12:16])[0]
    inner = head[32 + size:]
    if len(inner) >= 4:
        media, prob = type_find_data(inner)
        if prob > MINIMUM:
            return media, min(prob, ALMOST_CERTAIN)
    return None


def _ogg(head: bytes):
    """OggS: look at the BOS packet to classify the stream family
    (ogganx/theora/vorbis/speex/celt/kate/skeleton detectors in the
    reference)."""
    if not head.startswith(b"OggS"):
        return None
    nseg = head[26] if len(head) > 26 else 0
    body = head[27 + nseg:27 + nseg + 64]
    table = [
        (b"\x80theora", "video/ogg"),
        (b"\x01video\x00", "video/ogg"),       # OGM video
        (b"fishead\x00", "application/ogg"),   # skeleton
        (b"AnxData", "application/annodex"),
        (b"CMML\x00\x00\x00\x00", "text/x-cmml"),
        (b"\x01vorbis", "audio/ogg"),
        (b"OpusHead", "audio/ogg"),
        (b"Speex   ", "audio/ogg"),
        (b"CELT    ", "audio/ogg"),
        (b"\x7fFLAC", "audio/ogg"),
        (b"\x80kate\x00\x00\x00", "application/ogg"),
    ]
    for sig, media in table:
        if body.startswith(sig):
            return media, CERTAIN
    return "application/ogg", LIKELY


def _iff_form(head: bytes):
    """FORM-based EA-IFF85 family: AIFF, 8SVX, ILBM, WVQA, MOVE."""
    if head[:4] != b"FORM" or len(head) < 12:
        return None
    kind = head[8:12]
    table = {b"AIFF": "audio/x-aiff", b"AIFC": "audio/x-aiff",
             b"8SVX": "audio/x-svx", b"ILBM": "image/x-ilbm",
             b"WVQA": "video/x-vqa", b"MOVE": "video/x-mve"}
    if kind in table:
        return table[kind], CERTAIN
    return "application/x-iff", LIKELY


def _flx(head: bytes):
    if len(head) >= 6 and head[4:6] in (b"\x11\xaf", b"\x12\xaf"):
        return "video/x-fli", LIKELY
    return None


def _mod(head: bytes):
    """Amiga module magic at offset 1080 (mod_type_find)."""
    sig = head[1080:1084]
    if sig in (b"M.K.", b"M!K!", b"FLT4", b"FLT8", b"4CHN", b"6CHN",
               b"8CHN"):
        return "audio/x-mod", CERTAIN
    if head[:4] == b"IMPM":                        # impulse tracker
        return "audio/x-mod", CERTAIN
    if head[:17] == b"Extended Module: ":
        return "audio/x-mod", CERTAIN
    if head[44:48] == b"SCRM":                     # scream tracker
        return "audio/x-mod", CERTAIN
    return None


def _pnm(head: bytes):
    if len(head) >= 3 and head[0:1] == b"P" and head[1] in range(
            0x31, 0x38) and head[2] in (0x20, 0x09, 0x0a, 0x0d):
        kinds = {0x31: "bitmap", 0x34: "bitmap", 0x32: "graymap",
                 0x35: "graymap", 0x33: "pixmap", 0x36: "pixmap",
                 0x37: "anymap"}
        return (f"image/x-portable-{kinds[head[1]]}", CERTAIN)
    return None


def _sdp(head: bytes):
    if head.startswith(b"v=0"):
        return "application/sdp", LIKELY
    return None


def _xml_family(head: bytes):
    """XML sub-detectors (smil/ttml/xges/dash/mss/fcpxml/xmeml/svg)."""
    sample = head[:1024]
    if not sample.lstrip()[:1] == b"<":
        return None
    table = [
        (b"<smil", "application/smil"),
        (b"<svg", "image/svg+xml"),
        (b"<tt ", "application/ttml+xml"),
        (b"<MPD", "application/dash+xml"),
        (b"<SmoothStreamingMedia", "application/vnd.ms-sstr+xml"),
        (b"<ges>", "application/xges"),
        (b"<fcpxml", "application/x-fcpxml"),
        (b"<xmeml", "application/x-xmeml"),
        (b"<html", "text/html"),
        (b"<!DOCTYPE html", "text/html"),
    ]
    for sig, media in table:
        if sig in sample:
            return media, CERTAIN
    return None


def _utf_bom(head: bytes):
    if head[:4] in (b"\xff\xfe\x00\x00", b"\x00\x00\xfe\xff"):
        return "text/utf-32", LIKELY
    if head[:2] in (b"\xff\xfe", b"\xfe\xff"):
        return "text/utf-16", LIKELY
    return None


def _uri_list(head: bytes):
    try:
        lines = head[:512].decode("ascii").splitlines()
    except UnicodeDecodeError:
        return None
    real = [ln for ln in lines[:8] if ln and not ln.startswith("#")]
    if real and all("://" in ln for ln in real):
        return "text/uri-list", POSSIBLE
    return None


def _h263(head: bytes):
    # PSC: 17-bit start code 0000 0000 0000 0000 1, then 5-bit ver 00000
    if len(head) >= 3 and head[0] == 0 and head[1] == 0 \
            and (head[2] & 0xFC) == 0x80:
        return "video/x-h263, variant=(string)itu", POSSIBLE
    return None


def _mpeg4_video(head: bytes):
    if head[:3] == b"\x00\x00\x01" and len(head) >= 4 \
            and head[3] in (0xb0, 0xb5):           # VOS / VO startcodes
        return ("video/mpeg, mpegversion=(int)4, "
                "systemstream=(boolean)false"), LIKELY
    return None


def _dvdiso(head: bytes):
    if head[0x8001:0x8006] == b"CD001":
        return "application/x-cd-image", CERTAIN
    return None


def _sbc(head: bytes):
    if len(head) >= 2 and head[0] == 0x9C:
        return "audio/x-sbc", POSSIBLE
    return None


def _wav_family(head: bytes):
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "audio/x-wav", CERTAIN
    if head[:4] == b"RF64" and head[8:12] == b"WAVE":
        return "audio/x-rf64", CERTAIN
    return None


def _text(head: bytes):
    """UTF-8 plain text (utf8_type_find's spirit, simplified)."""
    if not head:
        return None
    sample = head[:256]
    try:
        sample.decode("utf-8")
    except UnicodeDecodeError:
        return None
    printable = sum(1 for b in sample
                    if 32 <= b < 127 or b in (9, 10, 13))
    if printable / len(sample) > 0.95:
        if sample.lstrip()[:5] == b"<?xml":
            return "application/xml", LIKELY
        if sample.startswith(b"#EXTM3U"):
            return "application/x-hls", LIKELY
        if sample.lstrip()[:1] in (b"{", b"["):
            return "application/json", POSSIBLE
        return "text/plain", POSSIBLE
    return None


_FINDERS: List[Callable] = [
    # raw/ingest formats first
    _magic(0, b"YUV4MPEG2 ", "application/x-yuv4mpeg"),
    _wav_family,
    _riff(b"AVI ", "video/x-msvideo"),
    _riff(b"WEBP", "image/webp"),
    _ebml,
    _qt,
    _magic(0, b"FLV", "video/x-flv"),
    _ogg,
    _magic(0, b"fLaC", "audio/x-flac"),
    _magic(0, b"MAC ", "audio/x-ape"),
    _magic(0, b"wvpk", "audio/x-wavpack"),
    _magic(0, b"MThd", "audio/midi"),
    _magic(0, b"FORM", "application/x-aiff", LIKELY),
    _magic(0, b".snd", "audio/x-au"),
    _magic(0, b"MPCK", "audio/x-musepack"),
    _magic(0, b"ADIF", "audio/mpeg, mpegversion=(int)4", LIKELY),
    _magic(0, b"#!AMR\n", "audio/amr"),
    _magic(0, b"#!AMR-WB\n", "audio/amr-wb"),
    _magic(0, b"TTA1", "audio/x-tta"),
    _magic(0, b"DSD ", "audio/x-dsf"),
    # images
    _magic(0, b"\x89PNG\r\n\x1a\n", "image/png"),
    _magic(0, b"\xff\xd8\xff", "image/jpeg"),
    _magic(0, b"GIF87a", "image/gif"),
    _magic(0, b"GIF89a", "image/gif"),
    _magic(0, b"BM", "image/bmp", LIKELY),
    _magic(0, b"II*\x00", "image/tiff"),
    _magic(0, b"MM\x00*", "image/tiff"),
    _magic(0, b"\x00\x00\x01\x00", "image/x-icon", LIKELY),
    _magic(0, b"8BPS", "image/x-psd"),
    _magic(0, b"gimp xcf", "image/x-xcf"),
    _magic(0, b"qoif", "image/qoi"),
    _magic(128, b"DICM", "application/dicom"),
    # video elementary / container
    _mpeg_ps,
    _mpeg_ts,
    _mpeg_video,
    _h26x,
    _magic(0, b"DKIF", "video/x-ivf"),
    _magic(0, b"\x06\x0e\x2b\x34", "application/mxf"),
    _magic(0, b"RMF", "application/vnd.rn-realmedia", LIKELY),
    _magic(0, b".RMF", "application/vnd.rn-realmedia"),
    _magic(0, b"\x30\x26\xb2\x75\x8e\x66\xcf\x11", "video/x-ms-asf"),
    _magic(0, b"BIK", "video/x-bink", LIKELY),
    _magic(0, b"SMK2", "video/x-smk", LIKELY),
    _magic(0, b"FILM", "video/x-film-cpk", LIKELY),
    _magic(0, b"4XMV", "video/x-4xm"),
    # audio elementary
    _mp3,
    _ac3,
    _dts,
    _aac_adts,
    _magic(0, b"MP+", "audio/x-musepack", LIKELY),
    # subtitles / playlists / misc
    _magic(0, b"WEBVTT", "application/x-subtitle-vtt"),
    _magic(0, b"[Script Info]", "application/x-ssa", LIKELY),
    _magic(0, b"%PDF-", "application/pdf"),
    _magic(0, b"PK\x03\x04", "application/zip", LIKELY),
    _magic(0, b"\x1f\x8b", "application/x-gzip"),
    _magic(0, b"BZh", "application/x-bzip"),
    _magic(0, b"\xfd7zXZ\x00", "application/x-xz"),
    _magic(0, b"7z\xbc\xaf\x27\x1c", "application/x-7z-compressed"),
    _magic(0, b"\x28\xb5\x2f\xfd", "application/zstd"),
    _magic(0, b"ustar", "application/x-tar", LIKELY),
    _magic(257, b"ustar", "application/x-tar"),
    _magic(0, b"\x7fELF", "application/x-executable", LIKELY),
    _magic(0, b"CWS", "application/x-shockwave-flash"),
    _magic(0, b"FWS", "application/x-shockwave-flash"),
    _magic(0, b"d8:announce", "application/x-bittorrent", LIKELY),
    _magic(0, b"\x00\x01\x00\x00\x00", "application/x-font-ttf", LIKELY),
    _magic(0, b"OTTO", "application/x-font-otf"),
    _magic(0, b"wOFF", "application/font-woff"),
    _magic(0, b"wOF2", "application/font-woff2"),
    # tags wrapping real content
    _id3v2,
    _apetag,
    # additional containers / codecs (typefind parity sweep)
    _iff_form,
    _flx,
    _mod,
    _pnm,
    _sdp,
    _xml_family,
    _utf_bom,
    _uri_list,
    _h263,
    _mpeg4_video,
    _dvdiso,
    _sbc,
    _magic(0, b"BBCD", "video/x-dirac"),
    _magic(0, b"\x1f\x07\x00", "video/x-dv, systemstream=(boolean)true",
           LIKELY),
    _magic(0, b"v/1\x01", "image/x-exr"),
    _magic(0, b"Interplay MVE File\x1a", "video/x-ipmovie"),
    _magic(0, b"NSVf", "video/x-nsv"),
    _magic(0, b"NSVs", "video/x-nsv"),
    _magic(0, b"NuppelVideo", "video/x-nuv"),
    _magic(0, b"nut/multimedia container", "video/x-nut", LIKELY),
    _magic(0, b" paf", "audio/x-paris", LIKELY),
    _magic(0, b"fap ", "audio/x-paris", LIKELY),
    _magic(0, b"%!", "application/postscript", LIKELY),
    _magic(0, b"#?RADIANCE\n", "image/vnd.radiance"),
    _magic(0, b"ajkg", "audio/x-shorten"),
    _magic(0, b"SMK4", "video/x-smk", LIKELY),
    _magic(0, b"MMMD", "application/vnd.smaf"),
    _magic(0, b"RSTM", "audio/x-brstm", LIKELY),
    _magic(0, b"FSTM", "audio/x-bfstm", LIKELY),
    _magic(0, b"FRM8", "audio/x-dsd", LIKELY),
    _magic(0, b"C64-TAPE-RAW", "audio/x-tap-tap"),
    _magic(0, b"C16-TAPE-RAW", "audio/x-tap-tap"),
    _magic(0, b"\x64\xa3\x01\x00", "audio/x-ircam", LIKELY),
    _magic(0, b"\x00\x01\xa3\x64", "audio/x-ircam", LIKELY),
    _magic(0, b"MZ", "application/x-ms-dos-executable", POSSIBLE),
    _magic(0, b"\x57\x90\x75\x36", "audio/audible", LIKELY),
    _magic(0, b"!<arch>", "application/x-ar", LIKELY),
    _magic(4, b"jP  ", "image/jp2"),
    _magic(0, b"\xff\x4f\xff\x51", "image/x-jpc"),
    _magic(4, b"idsc", "image/x-quicktime", LIKELY),
    _magic(4, b"idat", "image/x-quicktime", LIKELY),
    _magic(0, b"GXF\x00", "application/gxf", LIKELY),
    _magic(0, b"AV\x00", "video/x-pva", POSSIBLE),
    _magic(0, b"OTIO_SCHEMA", "application/x-otio", LIKELY),
    _magic(0, b"File Format=MacCaption_MCC",
           "application/x-mcc", CERTAIN),
    # text family LAST (weak heuristic)
    _text,
]


def type_find_data(head: bytes) -> Tuple[str, int]:
    """Sniff a buffer's media type (gst_type_find_helper semantics):
    every finder runs, the highest-probability result wins."""
    best: Tuple[str, int] = ("application/octet-stream", MINIMUM)
    for find in _FINDERS:
        try:
            r = find(head)
        except (IndexError, struct.error):
            r = None
        if r is not None and r[1] > best[1]:
            best = r
            if best[1] >= CERTAIN:
                break
    return best


def type_find_file(path: str) -> Tuple[str, int]:
    # 40 KiB window: ISO9660 needs 0x8001, mod magics sit at 1080,
    # id3v2 tags can span kilobytes before the payload
    with open(path, "rb") as f:
        return type_find_data(f.read(40960))


# media types the framework can decode to raw today
# sniffed media type -> autoplug route (gstdecodebin3.c picks
# rank-sorted factories; here the collapsed location-based demuxers
# ARE the decode chains).  A plain name is a source factory taking
# location=; a string with '!' is a launch-chain template where
# {path} is substituted (used when parse+decode are separate
# elements, e.g. mp3/aac).
DECODABLE = {
    "application/x-yuv4mpeg": "filesrc",
    "audio/x-wav": "wavparse",
    "application/ogg": "oggdemux",
    "audio/ogg": "oggdemux",
    "video/ogg": "oggdemux",
    "video/x-matroska": "matroskademux",
    "video/webm": "matroskademux",
    "video/quicktime": "qtdemux",
    "video/x-msvideo": "avidemux",
    "video/mpegts": "tsdemux",
    "video/mpeg, systemstream=(boolean)true": "mpegpsdemux",
    "audio/x-flac": "flacdec",
    "audio/x-aiff": "aiffparse",
    "video/x-flv": "flvdemux",
    "audio/mpeg, mpegversion=(int)1":
        "filesrc location={path} ! mpegaudioparse ! mpg123audiodec",
    "audio/mpeg, mpegversion=(int)4, framed=(boolean)false":
        "filesrc location={path} ! aacparse ! faad",
}


def decodable_for(mtype: str):
    """Route a sniffed type to its DECODABLE entry: exact match,
    then longest key that is a prefix of the full caps string (the
    sniffers append detail fields like layer= / variant=)."""
    if mtype in DECODABLE:
        return DECODABLE[mtype]
    best = None
    for key, factory in DECODABLE.items():
        if mtype.startswith(key) and (best is None
                                      or len(key) > len(best[0])):
            best = (key, factory)
    return best[1] if best else None
