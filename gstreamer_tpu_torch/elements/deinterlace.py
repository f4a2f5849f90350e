"""deinterlace — interlaced to progressive video.

The JAX package's ``elements/deinterlace.py`` element (reference
subprojects/gst-plugins-good/gst/deinterlace/ — method enum
gstdeinterlace.h:50-60, field history engine gstdeinterlace.c:1155-1270)
with its caps, field history, cross-tick carry and output field selection
copied, for the two intra-frame methods:

* linear: missing row = (above + below + 1) >> 1 (tvtime.orc
  deinterlace_line_linear, get_line CLAMP at the frame edges);
* scalerbob: missing row = the row above.

Both compute every field's frame from its own source frame, through
``ops/deint_kernel.py::deint_both_parities``: on a CUDA tensor its Hopper
kernel (``csrc/deint.cu``), on a CPU tensor its plain version.  The field
sequence of a batch is the TFF (or BFF) order of its frames' fields; the
last two input frames are carried to the next tick when ``fields`` is
top/bottom, exactly as the reference package does.

The temporal and motion-adaptive methods (greedyh, greedyl, vfir,
linearblend, weave*, tomsmocomp, yadif) are not ported yet and raise
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.value import Fraction
from ..ops import deint_kernel

DEINT_CAPS = ("video/x-raw, format={ I420, YV12, Y444, Y42B, NV12, AYUV }, "
              "width=[1,32767], height=[1,32767], "
              "framerate=[0/1,2147483647/1]")

METHODS = ["tomsmocomp", "greedyh", "greedyl", "vfir", "linear",
           "linearblend", "scalerbob", "weave", "weave-tff", "weave-bff",
           "yadif"]


@register_element
class Deinterlace(TransformElement):
    FACTORY = "deinterlace"
    DESCRIPTION = "Deinterlace video"
    HOST_ELEMENT = True     # carries true field history across ticks
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, DEINT_CAPS),
        PadTemplate("src", PadDirection.SRC, DEINT_CAPS),
    ]
    PROPERTIES = {
        "method": (str, "linear", "|".join(METHODS)),
        "mode": (str, "auto", "auto|interlaced|disabled"),
        "fields": (str, "all", "all|top|bottom"),
        "field-layout": (str, "tff", "tff|bff (auto falls back to tff "
                         "like the reference warning path)"),
        # method sub-properties of the methods not ported yet (kept so a
        # launch line that sets them still parses)
        "max-comb": (int, -1, "-1 = method default (greedyh 5, greedyl 15)"),
        "motion-threshold": (int, 25, "greedyh"),
        "motion-sense": (int, 30, "greedyh"),
        "search-effort": (int, 5, "tomsmocomp"),
        "strange-bob": (bool, False, "tomsmocomp bob variant"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._carry_planes = None       # planes of up to 2 carried frames

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            ns.fields.pop("interlace-mode", None)
            if self.props["fields"] == "all" and "framerate" in ns.fields:
                fr = ns["framerate"]
                if isinstance(fr, Fraction):
                    ns["framerate"] = (Fraction(fr.num * 2, fr.denom)
                                       if direction == PadDirection.SINK
                                       else Fraction(fr.num, fr.denom * 2))
            out.append(ns)
        res = Caps(out)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._method()
        self._mode = self.props["mode"]

    def start(self):
        self._carry_planes = None

    def _method(self) -> str:
        m = self.props["method"]
        if m not in deint_kernel.METHODS:
            raise NotImplementedError(
                f"deinterlace method={m!r} is not ported to "
                f"gstreamer_tpu_torch yet (ported: {deint_kernel.METHODS}; "
                "see ROADMAP.md)")
        return m

    def _deint_fields(self, plane: torch.Tensor, J: List[int],
                      parity0: int) -> torch.Tensor:
        """Output frames for field indices J, from one plane (NF, H, W).

        field i = frame i//2, parity (parity0 + i) % 2 (0 = top rows).
        The intra-frame methods have no cross-field dependency: both
        parities of every frame come from one kernel launch (1 read + 2
        writes), and the field sequence is a reshape.  Returns
        (len(J), H, W) in J order."""
        n_fields = 2 * plane.shape[0]
        both = deint_kernel.deint_both_parities(plane.contiguous(),
                                                self._method(), parity0)
        seq = both.reshape((n_fields,) + tuple(plane.shape[-2:]))
        if J == list(range(J[0], J[0] + len(J))):
            return seq[J[0]:J[0] + len(J)]
        return seq[torch.as_tensor(J, device=seq.device)]

    # -- tick processing ----------------------------------------------------
    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._mode == "disabled":
            return buf
        planes = tuple(buf.data)
        B = planes[0].shape[0]
        # prepend carried frames (true cross-tick history).  The
        # intra-frame methods never read them when every field is output
        # (the output range starts at the first new field and each field
        # needs only its own frame), so the concat is skipped there.
        intra_fast = self.props["fields"] == "all"
        carry_n = 0
        if self._carry_planes is not None and not intra_fast:
            carry_n = self._carry_planes[0].shape[0]
            planes = tuple(torch.cat([c, p], dim=0)
                           for c, p in zip(self._carry_planes, planes))
        NF = carry_n + B
        n_fields = 2 * NF
        parity0 = 0 if self.props["field-layout"] != "bff" else 1

        # output field range: the new frames' fields (the ported methods
        # have latency 0, so no field is held back to the next tick)
        J = list(range(2 * carry_n, n_fields))

        fields_sel = self.props["fields"]
        if fields_sel == "top":
            J = [j for j in J if (parity0 + j) % 2 == 0]
        elif fields_sel == "bottom":
            J = [j for j in J if (parity0 + j) % 2 == 1]

        out_planes = tuple(self._deint_fields(p, J, parity0) for p in planes)

        # carry the last 2 frames
        keep = min(2, NF)
        self._carry_planes = tuple(p[-keep:] for p in planes)

        dur = buf.duration
        if fields_sel == "all" and dur:
            dur = dur // 2
        return buf.with_(data=out_planes, batch=len(J), duration=dur)


@register_element
class AutoDeinterlace(Deinterlace):
    """autodeinterlace (gst-plugins-bad autoconvert family): the
    auto-mode deinterlacer under its own factory name."""
    FACTORY = "autodeinterlace"
    DESCRIPTION = "Deinterlace video automatically"
