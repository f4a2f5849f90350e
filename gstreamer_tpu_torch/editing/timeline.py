"""Timeline model + compositing sources (GES equivalent, reduced).

Semantics implemented from the reference:
- `Layer` stacking: lower priority number renders on top
  (ges-layer.c:46 "priority 0 ... most important").
- Same-layer overlap -> automatic crossfade transition when
  `timeline.auto_transition` is on (ges-timeline.c:107,
  ges-auto-transition.c); video alpha ramp + audio linear ramp
  (ges-video-transition.c crossfade, ges-smart-video-mixer.c).
- Clip timing: `start` (timeline position), `duration`, `inpoint`
  (media offset) — ges-timeline-element.c properties.
- `Effect("videobalance saturation=0.0")`: a launch fragment applied to
  the clip's media, like ges-effect.c bin descriptions.
- Gaps render black video / silent audio (nlecomposition's default
  sources).

A port of the JAX package's ``editing/timeline.py``.  Each clip's
sub-pipeline runs on the timeline source element's device (the outer
pipeline's, set at its compile; CUDA unless the caller names another, with
no fallback to the CPU), and its frames and samples stay tensors there:
the black of a gap is made there, the crossfade ``(b*alpha + a*(256 -
alpha)) >> 8`` runs there in int32, the audio mix in float64 with the JAX
package's rounding to S16 (round half to even, then clip), and a batch is
stacked there.  Only the timeline's plan (which clip, which progress) is
host arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement)
from ..core.value import Fraction
from ..device import resolve

NS = 1_000_000_000


@dataclass
class Effect:
    """ges-effect.c: an element-description fragment applied to the
    clip's media stream.  `keyframes` maps a child property to
    [(clip-local ns, value), ...] — the GES control-binding path
    (ges_track_element_set_control_source); values are applied through
    the framework's dynamic-property inputs, so animation never
    recompiles the clip program."""
    description: str
    keyframes: Dict[str, List[Tuple[int, float]]] = \
        field(default_factory=dict)

    def set_keyframe(self, prop: str, ts_ns: int,
                     value: float) -> None:
        self.keyframes.setdefault(prop, []).append((ts_ns, value))


@dataclass
class Clip:
    """Base clip (ges-clip.c): start/duration on the timeline, inpoint
    into the media."""
    start: int = 0              # ns on the timeline
    duration: int = NS
    inpoint: int = 0            # ns into the media
    effects: List[Effect] = field(default_factory=list)

    def add_effect(self, effect: Effect) -> None:
        self.effects.append(effect)

    @property
    def end(self) -> int:
        return self.start + self.duration

    # -- media description hooks (per track type) ---------------------------
    def video_launch(self, track: "VideoTrack") -> Optional[str]:
        return None

    def audio_launch(self, track: "AudioTrack") -> Optional[str]:
        return None

    def _effect_chain(self) -> str:
        parts = []
        for i, e in enumerate(self.effects):
            desc = e.description
            if e.keyframes and " name=" not in desc:
                head, _, rest = desc.partition(" ")
                desc = f"{head} name=__fx{i}__" + (f" {rest}" if rest
                                                  else "")
            parts.append(f" ! {desc}")
        return "".join(parts)

    def _attach_keyframes(self, pipeline) -> None:
        """Bind the effects' keyframes onto the built sub-pipeline."""
        from ..core.controller import InterpolationControlSource
        for i, e in enumerate(self.effects):
            if not e.keyframes:
                continue
            name = None
            if " name=" in e.description:
                name = e.description.split(" name=")[1].split()[0]
            el = pipeline.get_by_name(name or f"__fx{i}__")
            if el is None:
                continue
            for prop, kfs in e.keyframes.items():
                src = InterpolationControlSource()
                for ts, val in kfs:
                    src.set(ts, val)
                el.set_control_source(prop, src)


@dataclass
class TestClip(Clip):
    """ges-test-clip.c: videotestsrc pattern + audiotestsrc wave."""
    __test__ = False              # not a pytest class
    pattern: str = "smpte"
    wave: str = "sine"
    freq: float = 440.0
    volume: float = 0.8

    def video_launch(self, track):
        return (f"videotestsrc pattern={self.pattern}"
                + self._effect_chain())

    def audio_launch(self, track):
        return (f"audiotestsrc wave={self.wave} freq={self.freq} "
                f"volume={self.volume}" + self._effect_chain())


@dataclass
class UriClip(Clip):
    """ges-uri-clip.c (reduced): file-backed clip.  Video locations are
    .y4m / .avi / .mkv files, audio locations .wav / .avi / .mkv."""
    location: str = ""

    def _src_for(self, kind: str) -> str:
        loc = self.location
        if loc.endswith(".avi"):
            return f"avidemux location={loc} stream={kind}"
        if loc.endswith((".mkv", ".webm")):
            return f"matroskademux location={loc} stream={kind}"
        if loc.endswith((".mp4", ".mov")):
            return f"qtdemux location={loc} stream={kind}"
        if loc.endswith((".ts", ".m2ts")):
            return f"tsdemux location={loc}"
        if loc.endswith((".ogg", ".ogv", ".oga")):
            return f"oggdemux location={loc} stream={kind}"
        if kind == "audio":
            return f"wavparse location={loc}"
        return f"filesrc location={loc}"

    def video_launch(self, track):
        return self._src_for("video") + self._effect_chain()

    def audio_launch(self, track):
        return self._src_for("audio") + self._effect_chain()


@dataclass
class TitleClip(Clip):
    """ges-title-clip.c (reduced): rendered text over a solid
    background via the textoverlay family."""
    text: str = ""
    background: str = "black"        # videotestsrc pattern
    font_size: int = 24
    valignment: str = "center"
    halignment: str = "center"

    def video_launch(self, track):
        text = self.text.replace("\"", "")
        return (f"videotestsrc pattern={self.background} ! "
                f"textoverlay text=\"{text}\" "
                f"font-size={self.font_size} "
                f"valignment={self.valignment} "
                f"halignment={self.halignment}"
                + self._effect_chain())

    def audio_launch(self, track):
        return ("audiotestsrc wave=silence"
                + self._effect_chain())


@dataclass
class VideoTrack:
    """ges-video-track.c: restriction caps of the composited output."""
    width: int = 320
    height: int = 240
    fps: Fraction = field(default_factory=lambda: Fraction(30, 1))
    format: str = "I420"

    def caps_string(self) -> str:
        return (f"video/x-raw,format={self.format},width={self.width},"
                f"height={self.height},framerate={self.fps.num}/"
                f"{self.fps.denom}")


@dataclass
class AudioTrack:
    rate: int = 44100
    channels: int = 2
    format: str = "S16LE"

    def caps_string(self) -> str:
        return (f"audio/x-raw,format={self.format},rate={self.rate},"
                f"channels={self.channels},layout=interleaved")


class Layer:
    """ges-layer.c: an ordered set of clips; priority 0 is on top."""

    def __init__(self, priority: int = 0):
        self.priority = priority
        self.clips: List[Clip] = []

    def add_clip(self, clip: Clip) -> Clip:
        self.clips.append(clip)
        self.clips.sort(key=lambda c: c.start)
        return clip


class Timeline:
    """ges-timeline.c: layers x tracks; compiled per-track into
    timeline source elements."""

    def __init__(self, video: Optional[VideoTrack] = None,
                 audio: Optional[AudioTrack] = None,
                 auto_transition: bool = True):
        self.video_track = video
        self.audio_track = audio
        self.layers: List[Layer] = []
        self.auto_transition = auto_transition

    @classmethod
    def new_audio_video(cls) -> "Timeline":
        """ges_timeline_new_audio_video."""
        return cls(video=VideoTrack(), audio=AudioTrack())

    def append_layer(self) -> Layer:
        layer = Layer(priority=len(self.layers))
        self.layers.append(layer)
        return layer

    @property
    def duration(self) -> int:
        return max((c.end for layer in self.layers for c in layer.clips),
                   default=0)

    # -- stack evaluation ----------------------------------------------------
    def stack_at(self, t: int) -> List[Tuple[Layer, Clip]]:
        """Active (layer, clip) pairs at time t, top-most first."""
        out = []
        for layer in sorted(self.layers, key=lambda l: l.priority):
            for clip in layer.clips:
                if clip.start <= t < clip.end:
                    out.append((layer, clip))
        return out

    def transition_at(self, t: int):
        """Same-layer overlap (A ends while B runs): returns
        (clip_a, clip_b, progress in [0,1]) or None
        (ges-auto-transition.c)."""
        if not self.auto_transition:
            return None
        for layer in sorted(self.layers, key=lambda l: l.priority):
            active = [c for c in layer.clips if c.start <= t < c.end]
            if len(active) >= 2:
                a, b = sorted(active, key=lambda c: c.start)[:2]
                ov_start, ov_end = b.start, min(a.end, b.end)
                if ov_start <= t < ov_end and ov_end > ov_start:
                    return a, b, (t - ov_start) / (ov_end - ov_start)
        return None


class Group:
    """ges-group.c: a container spanning clips — possibly across
    layers — edited as one unit.  Moving the group (`group.start = t`
    or `shift(delta)`) translates every member, preserving their
    relative offsets; `ungroup()` dissolves it (ges_container_ungroup).
    """

    def __init__(self, clips: List[Clip]):
        if not clips:
            raise ValueError("group needs at least one clip")
        self.clips = list(clips)

    @classmethod
    def group(cls, clips: List[Clip]) -> "Group":
        """ges_container_group."""
        return cls(clips)

    @property
    def start(self) -> int:
        return min(c.start for c in self.clips)

    @start.setter
    def start(self, t: int) -> None:
        self.shift(t - self.start)

    @property
    def end(self) -> int:
        return max(c.end for c in self.clips)

    @property
    def duration(self) -> int:
        return self.end - self.start

    def shift(self, delta_ns: int) -> None:
        if delta_ns < -self.start:
            raise ValueError("group cannot move before t=0")
        for c in self.clips:
            c.start += delta_ns

    def ungroup(self) -> List[Clip]:
        clips, self.clips = self.clips, []
        return clips


# registry letting launch strings reference Timeline objects by id —
# the seam nested timelines use to appear inside a clip's sub-pipeline
_TIMELINES: Dict[int, Timeline] = {}


def register_timeline(tl: Timeline) -> int:
    tid = id(tl)
    _TIMELINES[tid] = tl
    return tid


@dataclass
class NestedTimelineClip(Clip):
    """Nested timeline (ges-timeline.c used as a clip source — the
    reference composes timelines inside timelines through nleComposition
    / the `ges://` URI of ges/ges-uri-clip.c): the clip's media is
    another Timeline, rendered by the timeline source elements inside
    the clip's sub-pipeline.  inpoint/duration/effects behave exactly
    as for any other clip."""
    timeline: Optional[Timeline] = None

    def video_launch(self, track):
        if self.timeline is None or self.timeline.video_track is None:
            return None
        tid = register_timeline(self.timeline)
        return f"timelinevideosrc timeline-id={tid}" \
            + self._effect_chain()

    def audio_launch(self, track):
        if self.timeline is None or self.timeline.audio_track is None:
            return None
        tid = register_timeline(self.timeline)
        return f"timelineaudiosrc timeline-id={tid}" \
            + self._effect_chain()


class _ClipStream:
    """Sequential frame/sample reader over a clip's sub-pipeline, on
    `device`: frames and samples stay tensors there."""

    def __init__(self, launch: str, caps: str, clip=None, device=None):
        from ..core.parse import parse_launch
        conv = ("videoconvertscale" if caps.startswith("video")
                else "audioconvert ! audioresample")
        self._p = parse_launch(
            f"{launch} ! {conv} ! {caps} ! appsink name=__out__",
            device=device)
        self.device = self._p.device
        if clip is not None:
            clip._attach_keyframes(self._p)
        self._sink = self._p.get_by_name("__out__")
        self._queue: List = []
        self._eos = False
        self._last = None

    def _pull(self):
        while not self._queue and not self._eos:
            if not self._p.tick():
                self._eos = True
                break
            while True:
                s = self._sink.pull_sample()
                if s is None:
                    break
                d = s.buffer.data
                if isinstance(d, (tuple, list)):
                    for k in range(d[0].shape[0]):
                        self._queue.append(tuple(x[k] for x in d))
                else:
                    self._queue.append(d)

    def next_video(self):
        self._pull()
        if self._queue:
            self._last = self._queue.pop(0)
        return self._last               # repeat last frame past EOS

    def read_audio(self, n: int, channels: int):
        """n sample frames (zero-padded past EOS)."""
        out = []
        got = 0
        while got < n:
            self._pull()
            if not self._queue:
                out.append(torch.zeros((n - got, channels),
                                       dtype=torch.float64,
                                       device=self.device))
                break
            chunk = self._queue[0]
            take = min(n - got, chunk.shape[0])
            out.append(chunk[:take].to(torch.float64))
            if take == chunk.shape[0]:
                self._queue.pop(0)
            else:
                self._queue[0] = chunk[take:]
            got += take
        return torch.cat(out, dim=0)

    def skip_video(self, n: int):
        for _ in range(n):
            self.next_video()

    def skip_audio(self, n: int, channels: int):
        if n:
            self.read_audio(n, channels)

    def close(self):
        self._p.set_state("NULL")


class TimelineVideoSrc(SourceElement):
    """Composites the timeline's video per frame: topmost active clip,
    crossfaded during same-layer transitions, black in gaps."""
    FACTORY = "timelinevideosrc"
    DESCRIPTION = "GES-equivalent timeline video source"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, "video/x-raw")]
    PROPERTIES = {
        "timeline": (object, None, "editing.Timeline"),
        "timeline-id": (int, 0, "registered timeline id (launch-"
                        "string seam; see register_timeline)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._streams: Dict[int, _ClipStream] = {}
        self._frame_idx = 0

    @property
    def _tl(self) -> Timeline:
        return (self.props["timeline"]
                or _TIMELINES[self.props["timeline-id"]])

    def get_caps(self, filter=None):
        caps = Caps.from_string(self._tl.video_track.caps_string())
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._streams = {}
        self._frame_idx = 0

    def stop(self):
        for s in self._streams.values():
            s.close()
        self._streams = {}

    def _stream(self, clip: Clip) -> Optional[_ClipStream]:
        key = id(clip)
        if key not in self._streams:
            track = self._tl.video_track
            launch = clip.video_launch(track)
            if launch is None:
                return None
            st = _ClipStream(launch, track.caps_string(),
                             clip=clip, device=resolve(self.device))
            fps = track.fps
            st.skip_video(int(clip.inpoint * fps.num // (NS * fps.denom)))
            self._streams[key] = st
        return self._streams[key]

    def _frame_at(self, t: int):
        track = self._tl.video_track
        h, w = track.height, track.width
        from ..video.format import format_info
        finfo = format_info(track.format)
        shapes = [(finfo.comp_height(c, h), finfo.comp_width(c, w))
                  for c in range(min(finfo.n_components, 3))]
        dev = resolve(self.device)
        black = tuple(
            torch.full(s, 0 if c == 0 else 128, dtype=torch.uint8,
                       device=dev)
            for c, s in enumerate(shapes))
        trans = self._tl.transition_at(t)
        if trans is not None:
            a, b, prog = trans
            fa = self._clip_frame(a) or black
            fb = self._clip_frame(b) or black
            alpha = int(prog * 256)
            return tuple(
                ((pb.to(torch.int32) * alpha
                  + pa.to(torch.int32) * (256 - alpha)) >> 8
                 ).to(torch.uint8) for pa, pb in zip(fa, fb))
        stack = self._tl.stack_at(t)
        if not stack:
            return black
        return self._clip_frame(stack[0][1]) or black

    def _clip_frame(self, clip: Clip):
        st = self._stream(clip)
        return st.next_video() if st is not None else None

    def create(self, n_frames: int) -> Optional[Buffer]:
        track = self._tl.video_track
        fps = track.fps
        total = self._tl.duration * fps.num // (NS * fps.denom)
        if self._frame_idx >= total:
            return None
        n = min(max(1, n_frames), total - self._frame_idx)
        frames = []
        for k in range(n):
            t = (self._frame_idx + k) * NS * fps.denom // fps.num
            frames.append(self._frame_at(t))
        pts = self._frame_idx * NS * fps.denom // fps.num
        self._frame_idx += n
        data = tuple(torch.stack([f[c] for f in frames])
                     for c in range(len(frames[0])))
        return Buffer(data=data, pts=pts,
                      duration=NS * fps.denom // fps.num, batch=n)


class TimelineAudioSrc(SourceElement):
    """Mixes the timeline's audio: topmost clip, linear crossfade on
    same-layer transitions, silence in gaps
    (ges-audio-transition.c volume ramps)."""
    FACTORY = "timelineaudiosrc"
    DESCRIPTION = "GES-equivalent timeline audio source"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, "audio/x-raw")]
    PROPERTIES = {
        "timeline": (object, None, "editing.Timeline"),
        "timeline-id": (int, 0, "registered timeline id (launch-"
                        "string seam; see register_timeline)"),
        "blocksize": (int, 1024, "sample frames per buffer"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._streams: Dict[int, _ClipStream] = {}
        self._pos = 0

    @property
    def _tl(self) -> Timeline:
        return (self.props["timeline"]
                or _TIMELINES[self.props["timeline-id"]])

    def get_caps(self, filter=None):
        caps = Caps.from_string(self._tl.audio_track.caps_string())
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._streams = {}
        self._pos = 0

    def stop(self):
        for s in self._streams.values():
            s.close()
        self._streams = {}

    def _stream(self, clip: Clip) -> Optional[_ClipStream]:
        key = id(clip)
        if key not in self._streams:
            track = self._tl.audio_track
            launch = clip.audio_launch(track)
            if launch is None:
                return None
            st = _ClipStream(launch, track.caps_string(),
                             clip=clip, device=resolve(self.device))
            st.skip_audio(int(clip.inpoint * track.rate // NS),
                          track.channels)
            self._streams[key] = st
        return self._streams[key]

    def create(self, n_frames: int) -> Optional[Buffer]:
        track = self._tl.audio_track
        rate, ch = track.rate, track.channels
        total = self._tl.duration * rate // NS
        if self._pos >= total:
            return None
        n = min(self.props["blocksize"] * max(1, n_frames),
                total - self._pos)
        dev = resolve(self.device)
        out = torch.zeros((n, ch), dtype=torch.float64, device=dev)
        # per-sample would be exact but slow; evaluate the stack per
        # sub-block at clip boundaries within [pos, pos+n)
        done = 0
        while done < n:
            t = (self._pos + done) * NS // rate
            # samples until the next clip boundary
            bounds = [c.start for l in self._tl.layers for c in l.clips]
            bounds += [c.end for l in self._tl.layers for c in l.clips]
            nxt = min((b for b in bounds if b > t),
                      default=self._tl.duration)
            seg = min(n - done, max(1, (nxt * rate // NS)
                                    - (self._pos + done)))
            trans = self._tl.transition_at(t)
            if trans is not None:
                a, b, _ = trans
                sa = self._stream(a)
                sb = self._stream(b)
                zeros = (seg, ch)
                xa = sa.read_audio(seg, ch) if sa else torch.zeros(
                    zeros, dtype=torch.float64, device=dev)
                xb = sb.read_audio(seg, ch) if sb else torch.zeros(
                    zeros, dtype=torch.float64, device=dev)
                ov_start, ov_end = b.start, min(a.end, b.end)
                s0 = self._pos + done
                # the ramp is host arithmetic (float64, as the JAX
                # package's); the mix runs on the device
                idx = (np.arange(seg) + s0) * NS / rate
                prog = torch.from_numpy(np.clip(
                    (idx - ov_start) / max(1, ov_end - ov_start),
                    0.0, 1.0)[:, None]).to(dev)
                out[done:done + seg] = xa * (1 - prog) + xb * prog
            else:
                stack = self._tl.stack_at(t)
                if stack:
                    st = self._stream(stack[0][1])
                    if st is not None:
                        out[done:done + seg] = st.read_audio(seg, ch)
            done += seg
        pts = self._pos * NS // rate
        self._pos += n
        samples = torch.round(out).clamp_(-32768, 32767).to(torch.int16) \
            if track.format.startswith("S16") else out
        return Buffer(data=samples, pts=pts,
                      duration=n * NS // rate, batch=1)


def register_editing_elements():
    from ..core.element import register_element
    register_element(TimelineVideoSrc)
    register_element(TimelineAudioSrc)


register_editing_elements()
