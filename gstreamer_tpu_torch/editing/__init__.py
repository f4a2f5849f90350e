"""Editing services — gst-editing-services (GES) equivalent, reduced.

Reference: subprojects/gst-editing-services/ges/ — ges-timeline.c
(layers + tracks container, auto-transition on same-layer overlap,
ges-timeline.c:107), ges-layer.c (priority stacking: layer 0 on top),
ges-clip.c (start/duration/inpoint), ges-test-clip.c / ges-uri-clip.c,
ges-effect.c (element-description effects per clip),
ges-video-transition.c (crossfade) / ges-audio-transition.c (linear
volume ramp), ges-track.c (video/audio restriction caps), and
ges-pipeline.c (timeline -> playable/renderable pipeline).

TPU-native reduction: a Timeline compiles to timeline source elements
(`TimelineVideoSrc`/`TimelineAudioSrc`) that composite the active clip
stack per batch on the host boundary while each clip's media flows
through a normal (fused, device-side) sub-pipeline; effects are launch
fragments spliced into the clip's sub-pipeline, exactly like GES
effects wrap element descriptions.

The port's copy: the timeline sources and every clip's sub-pipeline run on
the outer pipeline's device, their frames and samples tensors there
(``timeline.py``).  Importing this package registers ``timelinevideosrc``
and ``timelineaudiosrc`` in the port's registry, as the JAX package's
does in its own.
"""

from .timeline import (AudioTrack, Clip, Effect, Group, Layer,
                       NestedTimelineClip, TestClip, Timeline,
                       TimelineAudioSrc, TimelineVideoSrc, TitleClip,
                       UriClip, VideoTrack, register_timeline)

__all__ = ["Timeline", "Layer", "Clip", "TestClip", "UriClip", "Effect",
           "VideoTrack", "AudioTrack", "TimelineVideoSrc",
           "TimelineAudioSrc", "Group", "NestedTimelineClip",
           "TitleClip", "register_timeline"]
