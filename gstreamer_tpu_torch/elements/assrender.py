"""assrender — ASS/SSA styled subtitle rendering (reduced).

Clean-room reduction of gst-plugins-bad/ext/assrender/gstassrender.c
(which wraps libass).  Supported ASS subset (documented):

* [V4+ Styles] / [V4 Styles] sections: Fontsize, PrimaryColour,
  Bold, Italic, Underline, Alignment, MarginL/R/V per named style
  (from the `ass-header` caps field / codec-data, or inline in the
  event payload);
* Dialogue events: Layer, Start, End, Style, MarginL/R/V overrides,
  Text with \\N line breaks;
* override tags: {\\b0/1} {\\i0/1} {\\u0/1} {\\c&HBBGGRR&} /
  {\\1c&H..&} {\\an1-9} {\\a1-11 legacy} {\\pos(x,y)}; all other
  tags are ignored (stripped), like the reference does for tags
  libass knows but we reduce away.

Rendering uses the PIL rasterizer (DejaVu Sans; bold via the Bold
face, italic via a 0.2 shear — a documented reduction of libass's
full shaper) and blends through the exact video_blend math of
video/overlay.py onto I420/RGB frames.

subtitleoverlay (elements/subtitles_extra.py) routes
application/x-ass / application/x-ssa text through this renderer.

A port of the JAX package's ``elements/assrender.py``.  The subtitle text
stays host bytes (the text pad takes its source's bytes unstaged); a tick
with events to draw copies its planes to the host, blends every frame
there and moves the planes back to the video's device in one copy; a tick
without events passes the video's tensors as they are.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.element import (AggregatorElement, PadDirection, PadTemplate,
                            register_element)

_FONT_DIR = "/usr/share/fonts/truetype/dejavu/"


@dataclass
class AssStyle:
    name: str = "Default"
    fontsize: int = 18
    primary: Tuple[int, int, int] = (255, 255, 255)
    bold: bool = False
    italic: bool = False
    underline: bool = False
    alignment: int = 2                 # numpad: 2 = bottom center
    margin_l: int = 10
    margin_r: int = 10
    margin_v: int = 10


def _ass_color(v: str) -> Tuple[int, int, int]:
    """&HAABBGGRR& / &HBBGGRR& / decimal -> (R, G, B)."""
    v = v.strip().strip("&").lstrip("Hh")
    try:
        n = int(v, 16)
    except ValueError:
        try:
            n = int(v)
        except ValueError:
            return (255, 255, 255)
    return (n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF)


def parse_ass_styles(header: str) -> Dict[str, AssStyle]:
    """Parse the [V4+ Styles] section."""
    styles: Dict[str, AssStyle] = {}
    fmt: List[str] = []
    in_styles = False
    for line in header.splitlines():
        line = line.strip()
        low = line.lower()
        if low.startswith("["):
            in_styles = "styles" in low
            continue
        if not in_styles:
            continue
        if low.startswith("format:"):
            fmt = [f.strip().lower()
                   for f in line.split(":", 1)[1].split(",")]
        elif low.startswith("style:") and fmt:
            vals = [v.strip()
                    for v in line.split(":", 1)[1].split(",")]
            d = dict(zip(fmt, vals))
            st = AssStyle(name=d.get("name", "Default"))
            try:
                st.fontsize = int(float(d.get("fontsize", 18)))
            except ValueError:
                pass
            if "primarycolour" in d:
                st.primary = _ass_color(d["primarycolour"])
            st.bold = d.get("bold", "0") not in ("0", "")
            st.italic = d.get("italic", "0") not in ("0", "")
            st.underline = d.get("underline", "0") not in ("0", "")
            try:
                st.alignment = int(d.get("alignment", 2))
            except ValueError:
                pass
            for k, attr in (("marginl", "margin_l"),
                            ("marginr", "margin_r"),
                            ("marginv", "margin_v")):
                try:
                    setattr(st, attr, int(d.get(k, 10)))
                except ValueError:
                    pass
            styles[st.name] = st
    return styles


_TAG_RE = re.compile(r"\{([^}]*)\}")


@dataclass
class _Run:
    text: str
    bold: bool
    italic: bool
    underline: bool
    color: Tuple[int, int, int]


@dataclass
class AssEvent:
    start_ns: int
    end_ns: int
    style: str
    text_runs: List[List[_Run]]        # lines of styled runs
    alignment: Optional[int] = None
    pos: Optional[Tuple[int, int]] = None
    margin_l: int = 0
    margin_r: int = 0
    margin_v: int = 0


_LEGACY_AN = {1: 1, 2: 2, 3: 3, 5: 7, 6: 8, 7: 9, 9: 4, 10: 5, 11: 6}


def parse_dialogue(line: str, styles: Dict[str, AssStyle]
                   ) -> Optional[AssEvent]:
    parts = line.split(":", 1)[1].split(",", 9)
    if len(parts) < 10:
        return None

    def ts(t):
        h, m, s = t.strip().split(":")
        return int((int(h) * 3600 + int(m) * 60 + float(s)) * 1e9)

    try:
        t0, t1 = ts(parts[1]), ts(parts[2])
    except ValueError:
        return None
    style_name = parts[3].strip()
    st = styles.get(style_name, AssStyle())

    def safe_int(v):
        try:
            return int(v.strip())
        except ValueError:
            return 0

    ev = AssEvent(t0, t1, style_name, [],
                  margin_l=safe_int(parts[5]) or st.margin_l,
                  margin_r=safe_int(parts[6]) or st.margin_r,
                  margin_v=safe_int(parts[7]) or st.margin_v)
    raw = parts[9]

    bold, italic, underline = st.bold, st.italic, st.underline
    color = st.primary
    runs: List[_Run] = []
    lines: List[List[_Run]] = []
    pos = 0

    def flush_text(txt):
        nonlocal runs, lines
        for i, piece in enumerate(re.split(r"\\N|\\n", txt)):
            if i > 0:
                lines.append(runs)
                runs = []
            if piece:
                runs.append(_Run(piece, bold, italic, underline,
                                 color))

    for m in _TAG_RE.finditer(raw):
        flush_text(raw[pos:m.start()])
        pos = m.end()
        for tag in re.findall(r"\\[^\\]*", m.group(1)):
            tag = tag[1:]
            if tag.startswith("b") and tag[1:].isdigit():
                bold = tag[1:] != "0"
            elif tag.startswith("i") and tag[1:].isdigit():
                italic = tag[1:] != "0"
            elif tag.startswith("u") and tag[1:].isdigit():
                underline = tag[1:] != "0"
            elif tag.startswith("1c") or (tag.startswith("c")
                                          and "&" in tag):
                color = _ass_color(tag.split("&", 1)[1]
                                   if "&" in tag else tag[1:])
            elif tag.startswith("an") and tag[2:].isdigit():
                ev.alignment = int(tag[2:])
            elif tag.startswith("a") and tag[1:].isdigit():
                ev.alignment = _LEGACY_AN.get(int(tag[1:]), 2)
            elif tag.startswith("pos("):
                try:
                    x, y = tag[4:].rstrip(")").split(",")
                    ev.pos = (int(float(x)), int(float(y)))
                except ValueError:
                    pass
    flush_text(raw[pos:])
    if runs or not lines:
        lines.append(runs)
    ev.text_runs = lines
    if ev.alignment is None:
        ev.alignment = st.alignment
    return ev


def render_event(ev: AssEvent, styles: Dict[str, AssStyle]
                 ) -> np.ndarray:
    """Rasterize an event -> (h, w, 4) ARGB uint8 (straight alpha)."""
    from PIL import Image, ImageDraw, ImageFont

    st = styles.get(ev.style, AssStyle())

    def font_for(run: _Run):
        name = "DejaVuSans-Bold.ttf" if run.bold else "DejaVuSans.ttf"
        try:
            return ImageFont.truetype(_FONT_DIR + name, st.fontsize)
        except OSError:
            return ImageFont.load_default()

    # measure
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    line_sizes = []
    for runs in ev.text_runs:
        w = 0
        h = st.fontsize
        for run in runs:
            bbox = probe.textbbox((0, 0), run.text,
                                  font=font_for(run))
            w += bbox[2] - bbox[0] + 2
            h = max(h, bbox[3] - bbox[1] + 2)
        line_sizes.append((max(w, 1), max(int(h * 1.2), 1)))
    total_w = max(w for w, _ in line_sizes) + 8
    total_h = sum(h for _, h in line_sizes) + 8
    img = Image.new("RGBA", (total_w, total_h), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    y = 4
    for runs, (lw, lh) in zip(ev.text_runs, line_sizes):
        x = (total_w - lw) // 2          # center lines like libass
        for run in runs:
            font = font_for(run)
            bbox = draw.textbbox((0, 0), run.text, font=font)
            rw = bbox[2] - bbox[0]
            if run.italic:
                # shear a run-sized patch (synthetic oblique)
                patch = Image.new("RGBA", (rw + lh, lh + 4),
                                  (0, 0, 0, 0))
                pd = ImageDraw.Draw(patch)
                pd.text((-bbox[0] + lh // 4, -bbox[1] + 2), run.text,
                        fill=run.color + (255,), font=font)
                patch = patch.transform(
                    patch.size, Image.AFFINE,
                    (1, 0.2, -0.2 * lh / 2, 0, 1, 0))
                img.alpha_composite(patch, (x, y))
            else:
                draw.text((x - bbox[0], y - bbox[1] + 2), run.text,
                          fill=run.color + (255,), font=font)
            if run.underline:
                uy = y + lh - 4
                draw.line((x, uy, x + rw, uy),
                          fill=run.color + (255,), width=1)
            x += rw + 2
        y += lh
    rgba = np.asarray(img, np.uint8)
    return np.concatenate([rgba[..., 3:4], rgba[..., :3]], axis=-1)


def place(ev: AssEvent, bw: int, bh: int, W: int, H: int
          ) -> Tuple[int, int]:
    """Numpad-alignment placement with margins, or explicit \\pos."""
    if ev.pos is not None:
        return (max(ev.pos[0] - bw // 2, 0),
                max(ev.pos[1] - bh // 2, 0))
    an = ev.alignment or 2
    col = (an - 1) % 3                 # 0 left, 1 center, 2 right
    row = (an - 1) // 3                # 0 bottom, 1 middle, 2 top
    if col == 0:
        x = ev.margin_l
    elif col == 1:
        x = (W - bw) // 2
    else:
        x = W - bw - ev.margin_r
    if row == 0:
        y = H - bh - ev.margin_v
    elif row == 1:
        y = (H - bh) // 2
    else:
        y = ev.margin_v
    return max(x, 0), max(y, 0)


def blend_argb_i420(planes: List[np.ndarray], k: int,
                    bmp: np.ndarray, x0: int, y0: int) -> None:
    """Blend a straight-alpha ARGB bitmap onto frame k of I420 planes
    (video/overlay.py blend math: per-plane alpha mix)."""
    Y, U, V = planes[0], planes[1], planes[2]
    H, W = Y.shape[-2], Y.shape[-1]
    bh, bw = bmp.shape[:2]
    h2 = min(bh, H - y0)
    w2 = min(bw, W - x0)
    if h2 <= 0 or w2 <= 0:
        return
    a = bmp[:h2, :w2, 0].astype(np.float64) / 255.0
    r = bmp[:h2, :w2, 1].astype(np.float64)
    g = bmp[:h2, :w2, 2].astype(np.float64)
    b = bmp[:h2, :w2, 3].astype(np.float64)
    # BT.601 limited-range like video-blend.c
    yv = 16 + (0.256788 * r + 0.504129 * g + 0.097906 * b)
    uv = 128 + (-0.148223 * r - 0.290993 * g + 0.439216 * b)
    vv = 128 + (0.439216 * r - 0.367788 * g - 0.071427 * b)
    reg = Y[k, y0:y0 + h2, x0:x0 + w2].astype(np.float64)
    Y[k, y0:y0 + h2, x0:x0 + w2] = np.clip(
        np.rint(reg * (1 - a) + yv * a), 0, 255).astype(np.uint8)
    # chroma at half res
    a2 = a[::2, ::2]
    u2 = uv[::2, ::2]
    v2 = vv[::2, ::2]
    cx, cy = x0 // 2, y0 // 2
    ch, cw = a2.shape
    ch = min(ch, U.shape[-2] - cy)
    cw = min(cw, U.shape[-1] - cx)
    if ch <= 0 or cw <= 0:
        return
    regu = U[k, cy:cy + ch, cx:cx + cw].astype(np.float64)
    regv = V[k, cy:cy + ch, cx:cx + cw].astype(np.float64)
    U[k, cy:cy + ch, cx:cx + cw] = np.clip(
        np.rint(regu * (1 - a2[:ch, :cw]) + u2[:ch, :cw]
                * a2[:ch, :cw]), 0, 255).astype(np.uint8)
    V[k, cy:cy + ch, cx:cx + cw] = np.clip(
        np.rint(regv * (1 - a2[:ch, :cw]) + v2[:ch, :cw]
                * a2[:ch, :cw]), 0, 255).astype(np.uint8)


@register_element
class AssRender(AggregatorElement):
    """assrender (gstassrender.c, reduced): blends ASS/SSA styled
    subtitles over I420 video."""
    FACTORY = "assrender"
    DESCRIPTION = "Renders ASS/SSA subtitles on top of a video stream"
    HOST_ELEMENT = True
    HOST_INPUT_PADS = ("text",)        # text; the video pad takes media
    PAD_TEMPLATES = [
        PadTemplate("video", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("text", PadDirection.SINK,
                    "application/x-ass; application/x-ssa"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]
    PROPERTIES = {
        "enable": (bool, True, "enable rendering of subtitles"),
        "embeddedfonts": (bool, True, "accepted for API parity "
                                      "(PIL uses system fonts)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._styles: Dict[str, AssStyle] = {}

    def negotiate_output(self, in_caps, allowed):
        text = in_caps.get("text")
        if text is not None and len(text):
            hdr = text[0].get("ass-header") or text[0].get(
                "codec-data")
            if isinstance(hdr, (bytes, bytearray)):
                hdr = hdr.decode("utf-8", errors="replace")
            if isinstance(hdr, str) and hdr:
                self._styles = parse_ass_styles(hdr)
        return in_caps.get("video")

    def _events_of(self, sub: Buffer) -> List[AssEvent]:
        d = sub.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        out = []
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).ravel().astype(np.uint8)
                   .tobytes())
            text = raw.decode("utf-8", errors="replace")
            # inline [Script Info] documents carry their own styles
            if "[Script Info]" in text or "[V4+ Styles]" in text:
                self._styles.update(parse_ass_styles(text))
            for line in text.splitlines():
                if line.strip().startswith("Dialogue:"):
                    ev = parse_dialogue(line.strip(), self._styles)
                    if ev is not None:
                        out.append(ev)
        return out

    def host_aggregate(self, ins: Dict[str, Buffer]
                       ) -> Optional[Buffer]:
        video = ins.get("video")
        if video is None:
            return None
        sub = ins.get("text")
        if sub is None or not bool(self.props["enable"]):
            return video
        events = self._events_of(sub)
        if not events:
            return video
        planes = [np.array(host_array(p)) for p in video.data]
        if planes[0].ndim == 2:
            planes = [p[None] for p in planes]
        n = planes[0].shape[0]
        H, W = planes[0].shape[-2:]
        for ev in events:
            bmp = render_event(ev, self._styles)
            x0, y0 = place(ev, bmp.shape[1], bmp.shape[0], W, H)
            for k in range(n):
                blend_argb_i420(planes, k, bmp, x0, y0)
        if video.data[0].ndim == 2:
            planes = [p[0] for p in planes]
        return video.with_(data=device_planes(planes, video.data))
