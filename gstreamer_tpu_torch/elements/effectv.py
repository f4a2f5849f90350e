"""EffecTV video effects -- exact ports of the classic effectv kernels.

The JAX package's ``elements/effectv.py`` (reference:
subprojects/gst-plugins-good/gst/effectv/ -- gstedge.c, gststreak.c,
gstshagadelic.c, gstvertigo.c, gstquark.c, gstrev.c, gstdice.c, gstwarp.c,
gstripple.c, gstaging.c, gstop.c, gstradioac.c; fastrand = state *
1103515245 + 12345, gsteffectv.h:40) with its numpy golds (``_frame``)
copied and its device scans rewritten on torch.

Pixels are processed as the reference's guint32 words (R<<16 | G<<8 | B)
reassembled from the canonical component planes; all math is exact
integer (int32 words on the device, int64 where the C's uint32 LCG
arithmetic needs the room).  Eight effects (edgetv, streaktv,
shagadelictv, vertigotv, quarktv, revtv, dicetv, warptv) run as a scan
over the frames of a tick (``make_scan_fn``), their feedback state carried
on the device across ticks by the Pipeline; host-sequential per-frame
parameters (vertigotv's phase, warptv's counter) come from ``scan_aux``.
Four (rippletv, agingtv, optv, radioactv) stay host elements: their planes
come to the host, run the per-frame numpy arithmetic and go back to the
buffer's device.  No hand-written kernel: the JAX package computes the
scans as plain XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo
from .videotestsrc import lcg_affine

RGB_CAPS = ("video/x-raw, format={ BGRx, RGBx, xRGB, RGB, RGBA, BGRA }, "
            "width=[1,32767], height=[1,32767], "
            "framerate=[0/1,2147483647/1]")

M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    """A Python int wrapped to int32, as the reference's int32 carry."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def _words(planes) -> np.ndarray:
    """(R,G,B[,A]) component planes -> (B, H, W) int64 guint32 words."""
    r, g, b = (np.asarray(planes[i]).astype(np.int64) for i in range(3))
    return (r << 16) | (g << 8) | b


def _unwords(w: np.ndarray, planes):
    out = [((w >> 16) & 0xFF).astype(np.uint8),
           ((w >> 8) & 0xFF).astype(np.uint8),
           (w & 0xFF).astype(np.uint8)]
    if len(planes) > 3:
        out.append(np.asarray(planes[3]))
    return tuple(out)


class _EffectvBase(TransformElement):
    """Base for the effectv family.

    Two execution paths:

    * ``_frame(w)`` -- the numpy gold (the exact line-by-line port of the
      reference C), run by the host effects and by the tests;
    * ``_scan_step(carry, w, aux, consts)`` -- the device path: the
      Pipeline runs it over the frames of a tick (``make_scan_fn``), the
      feedback state (``carry``) living on the device across ticks;
      ``consts`` are the effect's static tables on the frame's device
      (``_scan_consts``).  Effects with it set DEVICE_SCAN = True and
      HOST_ELEMENT = False.
    """

    HOST_ELEMENT = True
    DEVICE_SCAN = False
    HAS_AUX = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGB_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info: Optional[VideoInfo] = None

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])
            self._reset()

    def start(self):
        self._reset()

    def _reset(self):
        pass

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        """The numpy gold over the buffer's frames, on the host; the
        planes go back to the buffer's device."""
        dev = buf.data[0].device
        planes = tuple(p.cpu().numpy() for p in buf.data)
        w = _words(planes)
        out = np.empty_like(w)
        for k in range(w.shape[0]):
            out[k] = self._frame(w[k])
        res = _unwords(out, planes)
        return buf.with_(data=tuple(torch.from_numpy(p).to(dev)
                                    for p in res[:3]) + tuple(buf.data[3:]))

    def _frame(self, w: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- device scan path ---------------------------------------------------
    def _init_carry(self):
        return np.int32(0)          # dummy for stateless effects

    def _scan_consts(self, dev) -> dict:
        return {}

    def _scan_step(self, carry, w, aux, consts):
        raise NotImplementedError

    def make_scan_fn(self):
        if not self.DEVICE_SCAN or self._info is None:
            return None
        consts = {}                 # device -> the effect's static tables

        def step(carry, x):
            planes, aux = x if self.HAS_AUX else (x, None)
            dev = planes[0].device
            if dev not in consts:
                consts[dev] = self._scan_consts(dev)
            w = ((planes[0].to(torch.int32) << 16)
                 | (planes[1].to(torch.int32) << 8)
                 | planes[2].to(torch.int32))
            carry, out = self._scan_step(carry, w, aux, consts[dev])
            dt = planes[0].dtype
            outp = (((out >> 16) & 0xFF).to(dt), ((out >> 8) & 0xFF).to(dt),
                    (out & 0xFF).to(dt))
            return carry, outp + tuple(planes[3:])

        return step, self._init_carry()


def _sat_add_words(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The edgetv byte-saturated add: r = a+b; g = r & 0x01010100;
    out = r | (g - (g >> 8))  (gstedge.c:171)."""
    r = a + b
    g = r & 0x01010100
    return r | (g - (g >> 8))


@register_element
class EdgeTV(_EffectvBase):
    FACTORY = "edgetv"
    DESCRIPTION = "Apply edge detect on video"

    def _reset(self):
        if self._info is None:
            return
        mw = self._info.width // 4
        mh = self._info.height // 4
        self._map = np.zeros((mh, mw, 2), np.int64)

    def _frame(self, w):
        info = self._info
        mw, mh = info.width // 4, info.height // 4
        out = np.zeros_like(w)
        # reference pixels of each interior block (row 4y, col 4x)
        ys = np.arange(1, mh - 1)
        xs = np.arange(1, mw - 1)
        p = w[4 * ys[:, None], 4 * xs[None, :]]
        ql = w[4 * ys[:, None], 4 * xs[None, :] - 1]
        qu = w[4 * ys[:, None] - 1, 4 * xs[None, :]]

        def diffmap(p, q):
            r = ((p & 0xFF0000) - (q & 0xFF0000)) >> 16
            g = ((p & 0xFF00) - (q & 0xFF00)) >> 8
            b = (p & 0xFF) - (q & 0xFF)
            r = np.minimum((r * r) >> 5, 127)
            g = np.minimum((g * g) >> 5, 127)
            b = np.minimum((b * b) >> 4, 255)
            return (r << 17) | (g << 9) | b

        v2 = diffmap(p, ql)
        v3 = diffmap(p, qu)
        newmap = self._map.copy()
        newmap[1:mh - 1, 1:mw - 1, 0] = v2
        newmap[1:mh - 1, 1:mw - 1, 1] = v3
        # v0 = map[y-1][x][0] and v1 = map[y][x-1][1] AFTER this frame's
        # writes at those positions (the C updates in scan order)
        v0 = newmap[0:mh - 2, 1:mw - 1, 0]
        v1 = newmap[1:mh - 1, 0:mw - 2, 1]
        self._map = newmap

        by = 4 * ys[:, None]
        bx = 4 * xs[None, :]
        out[by, bx] = _sat_add_words(v0, v1)
        out[by, bx + 1] = _sat_add_words(v0, v3)
        out[by, bx + 2] = v3
        out[by, bx + 3] = v3
        out[by + 1, bx] = _sat_add_words(v2, v1)
        out[by + 1, bx + 1] = _sat_add_words(v2, v3)
        out[by + 1, bx + 2] = v3
        out[by + 1, bx + 3] = v3
        # (rows 4y+2/4y+3 and the border blocks stay black — the C leaves
        # them unwritten in the fresh output buffer)
        return out & M32

    DEVICE_SCAN = True
    HOST_ELEMENT = False

    def _init_carry(self):
        mw = self._info.width // 4
        mh = self._info.height // 4
        return np.zeros((mh, mw, 2), np.int32)

    def _scan_step(self, carry, w, aux, k):
        info = self._info
        mw, mh = info.width // 4, info.height // 4
        p = w[4:4 * (mh - 1):4, 4:4 * (mw - 1):4]
        ql = w[4:4 * (mh - 1):4, 3:4 * (mw - 1) - 1:4]
        qu = w[3:4 * (mh - 1) - 1:4, 4:4 * (mw - 1):4]

        def diffmap(p, q):
            r = ((p & 0xFF0000) - (q & 0xFF0000)) >> 16
            g = ((p & 0xFF00) - (q & 0xFF00)) >> 8
            b = (p & 0xFF) - (q & 0xFF)
            r = torch.clamp((r * r) >> 5, max=127)
            g = torch.clamp((g * g) >> 5, max=127)
            b = torch.clamp((b * b) >> 4, max=255)
            return (r << 17) | (g << 9) | b

        v2 = diffmap(p, ql)
        v3 = diffmap(p, qu)
        # the map is this element's own state: updated in place (the C
        # writes it in scan order, so v0 / v1 read this frame's values)
        carry[1:mh - 1, 1:mw - 1, 0] = v2
        carry[1:mh - 1, 1:mw - 1, 1] = v3
        v0 = carry[0:mh - 2, 1:mw - 1, 0]
        v1 = carry[1:mh - 1, 0:mw - 2, 1]

        def pad(a):
            out = torch.zeros((mh, mw), dtype=a.dtype, device=a.device)
            out[1:mh - 1, 1:mw - 1] = a
            return out

        v0f, v1f, v2f, v3f = pad(v0), pad(v1), pad(v2), pad(v3)
        z = torch.zeros_like(v3f)
        blk = torch.stack([
            _sat_add_words(v0f, v1f), _sat_add_words(v0f, v3f), v3f, v3f,
            _sat_add_words(v2f, v1f), _sat_add_words(v2f, v3f), v3f, v3f,
            z, z, z, z, z, z, z, z], dim=-1).reshape(mh, mw, 4, 4)
        out = torch.zeros_like(w)
        out[:mh * 4, :mw * 4] = blk.permute(0, 2, 1, 3).reshape(mh * 4,
                                                                mw * 4)
        return carry, out & 0xFFFFFF


@register_element
class StreakTV(_EffectvBase):
    FACTORY = "streaktv"
    DESCRIPTION = "Makes after-image of moving objects"
    PROPERTIES = {"feedback": (bool, False, "feedback mode")}

    def _reset(self):
        if self._info is None:
            return
        shape = (32, self._info.height, self._info.width)
        self._planes = np.zeros(shape, np.int64)
        self._plane = 0

    def _frame(self, w):
        fb = self.props["feedback"]
        mask, stride, shift = ((0xFCFCFCFC, 8, 2) if fb
                               else (0xF8F8F8F8, 4, 3))
        self._planes[self._plane] = (w & mask) >> shift
        cf = self._plane & (stride - 1)
        if fb:
            dest = (self._planes[cf] + self._planes[cf + stride]
                    + self._planes[cf + stride * 2]
                    + self._planes[cf + stride * 3])
            self._planes[self._plane] = (dest & mask) >> shift
        else:
            dest = sum(self._planes[cf + stride * k] for k in range(8))
        self._plane = (self._plane + 1) & 31
        return dest & M32

    DEVICE_SCAN = True
    HOST_ELEMENT = False

    def _init_carry(self):
        shape = (32, self._info.height, self._info.width)
        return (np.zeros(shape, np.int32), np.int32(0))

    def _scan_step(self, carry, w, aux, k):
        planes, plane = carry
        fb = self.props["feedback"]
        mask, stride, shift = ((0xFCFCFCFC & 0xFFFFFF, 8, 2) if fb
                               else (0xF8F8F8F8 & 0xFFFFFF, 4, 3))
        # the 32-plane ring is this element's own state: written in place
        planes[plane] = (w & mask) >> shift
        cf = plane & (stride - 1)
        dest = planes[cf::stride].sum(0, dtype=torch.int32)
        if fb:
            planes[plane] = (dest & mask) >> shift
        return (planes, (plane + 1) & 31), dest & 0xFFFFFF


@register_element
class ShagadelicTV(_EffectvBase):
    FACTORY = "shagadelictv"
    DESCRIPTION = "Oh behave, ShagadelicTV makes images shagadelic!"

    def _reset(self):
        if self._info is None:
            return
        wdt, hgt = self._info.width, self._info.height
        yy = (np.arange(2 * hgt)[:, None] - hgt).astype(np.float64) ** 2
        xx = (np.arange(2 * wdt)[None, :] - wdt).astype(np.float64)
        self._ripple = (np.sqrt(xx * xx + yy) * 8).astype(np.uint64) & 255
        sy = (np.arange(hgt)[:, None] - hgt // 2).astype(np.float64)
        sx = (np.arange(wdt)[None, :] - wdt // 2).astype(np.float64)
        self._spiral = (np.arctan2(sx, sy + np.zeros_like(sx)) / math.pi
                        * 256 * 9
                        + np.sqrt(sx * sx + sy * sy) * 5
                        ).astype(np.int64).astype(np.uint64) & 255
        # fastrand starts at 0 (static guint, gsteffectv.h:42)
        s = 0
        vals = []
        for _ in range(4):
            s = (s * 1103515245 + 12345) & M32
            vals.append(s)
        self._rx, self._ry = vals[0] % wdt, vals[1] % hgt
        self._bx, self._by = vals[2] % wdt, vals[3] % hgt
        self._rvx = self._rvy = -2
        self._bvx = self._bvy = 2
        self._phase = 0

    def _frame(self, w):
        wdt, hgt = self._info.width, self._info.height
        v = w | 0x1010100
        v = (v - 0x707060) & 0x1010100
        v = v - (v >> 8)
        rip = self._ripple

        def chan(tab, off, mult):
            # ((gint8)(table + phase*mult)) >> 7 — arithmetic shift of the
            # byte reinterpreted signed: 0 or -1 (0xFF..)
            t = (tab.astype(np.int64) + self._phase * mult) & 0xFF
            return np.where(t >= 128, 0xFF, 0)

        r = chan(rip[self._ry:self._ry + hgt, self._rx:self._rx + wdt],
                 0, 2)
        g = chan(self._spiral, 0, 3)
        b = chan(rip[self._by:self._by + hgt, self._bx:self._bx + wdt],
                 0, -1)
        out = v & ((r << 16) | (g << 8) | b)

        self._phase -= 8
        for a, va, lim in (("_rx", "_rvx", wdt), ("_ry", "_rvy", hgt),
                           ("_bx", "_bvx", wdt), ("_by", "_bvy", hgt)):
            pos, vel = getattr(self, a), getattr(self, va)
            if pos + vel < 0 or pos + vel >= lim:
                vel = -vel
                setattr(self, va, vel)
            setattr(self, a, pos + vel)
        return out & M32

    DEVICE_SCAN = True
    HOST_ELEMENT = False

    def _init_carry(self):
        return (np.int32(self._phase),
                np.int32(self._rx), np.int32(self._ry),
                np.int32(self._bx), np.int32(self._by),
                np.int32(self._rvx), np.int32(self._rvy),
                np.int32(self._bvx), np.int32(self._bvy))

    def _scan_consts(self, dev):
        return dict(rip=torch.as_tensor(self._ripple.astype(np.int32),
                                        device=dev),
                    spiral=torch.as_tensor(self._spiral.astype(np.int32),
                                           device=dev))

    def _scan_step(self, carry, w, aux, k):
        phase, rx, ry, bx, by, rvx, rvy, bvx, bvy = carry
        wdt, hgt = self._info.width, self._info.height
        v = w | 0x1010100
        v = (v - 0x707060) & 0x1010100
        v = v - (v >> 8)

        def chan(tab, mult):
            # ((gint8)(table + phase*mult)) >> 7: 0 or 0xFF
            return (((tab + ((phase * mult) & 0xFF)) & 0xFF) >> 7) * 0xFF

        def window(y, x):
            # lax.dynamic_slice's start clamp, done explicitly
            y, x = min(max(y, 0), hgt), min(max(x, 0), wdt)
            return k["rip"][y:y + hgt, x:x + wdt]

        r = chan(window(ry, rx), 2)
        g = chan(k["spiral"], 3)
        b = chan(window(by, bx), -1)
        out = v & ((r << 16) | (g << 8) | b)

        def bounce(pos, vel, lim):
            nxt = pos + vel
            if nxt < 0 or nxt >= lim:
                vel = -vel
            return pos + vel, vel

        rx, rvx = bounce(rx, rvx, wdt)
        ry, rvy = bounce(ry, rvy, hgt)
        bx, bvx = bounce(bx, bvx, wdt)
        by, bvy = bounce(by, bvy, hgt)
        return ((_i32(phase - 8), rx, ry, bx, by, rvx, rvy, bvx, bvy),
                out & 0xFFFFFF)


@register_element
class VertigoTV(_EffectvBase):
    FACTORY = "vertigotv"
    DESCRIPTION = "A loopback alpha blending effector with rotating and scaling"
    PROPERTIES = {
        "speed": (float, 0.02, "phase increment"),
        "zoom-speed": (float, 1.01, "zoom rate"),
    }

    def _reset(self):
        if self._info is None:
            return
        area = self._info.width * self._info.height
        self._cur = np.zeros(area + 1, np.int64)
        self._alt = np.zeros(area + 1, np.int64)
        self._phase = 0.0

    def _set_parms(self):
        info = self._info
        wdt, hgt = info.width, info.height
        phase = self._phase
        dizz = math.sin(phase) * 10 + math.sin(phase * 1.9 + 5) * 5
        x, y = wdt / 2, hgt / 2
        t = (x * x + y * y) * float(self.props["zoom-speed"])
        if wdt > hgt:
            dizz = min(dizz, x) if dizz >= 0 else max(dizz, -x)
            vx = (x * (x - dizz) + y * y) / t
            vy = (dizz * y) / t
        else:
            dizz = min(dizz, y) if dizz >= 0 else max(dizz, -y)
            vx = (x * x + y * (y - dizz)) / t
            vy = (dizz * x) / t
        self._dx = int(vx * 65536)
        self._dy = int(vy * 65536)
        self._sx = int((-vx * x + vy * y + x + math.cos(phase * 5) * 2)
                       * 65536)
        self._sy = int((-vx * y - vy * x + y + math.sin(phase * 6) * 2)
                       * 65536)
        self._phase += float(self.props["speed"])
        if self._phase > 5700000:
            self._phase = 0.0

    def _frame(self, w):
        info = self._info
        wdt, hgt = info.width, info.height
        area = wdt * hgt
        self._set_parms()
        xs = np.arange(wdt, dtype=np.int64)
        ys = np.arange(hgt, dtype=np.int64)
        # per-row ox starts at sx - y*dy; per-col step dx (and oy dual)
        ox = (self._sx - ys[:, None] * self._dy) + xs[None, :] * self._dx
        oy = (self._sy + ys[:, None] * self._dx) + xs[None, :] * self._dy
        i = (oy >> 16) * wdt + (ox >> 16)
        i = np.clip(i, 0, area)
        # (index `area` emulates the C's one-past read as 0)
        v = self._cur[i] & 0xFCFCFF
        v = v * 3 + (w & 0xFCFCFF)
        out = (v >> 2) & M32
        self._alt[:area] = out.reshape(-1)
        self._cur, self._alt = self._alt, self._cur
        return out

    DEVICE_SCAN = True
    HOST_ELEMENT = False
    HAS_AUX = True

    def _init_carry(self):
        area = self._info.width * self._info.height
        return np.zeros(area + 1, np.int32)

    def scan_aux(self, batch: int):
        """Per-frame warp parameters: the phase recurrence runs on the
        host in float64 (exactly like the C doubles) and ships the
        int32 fixed-point parms into the scan."""
        parms = np.empty((batch, 4), np.int64)
        for k in range(batch):
            self._set_parms()
            parms[k] = (self._dx, self._dy, self._sx, self._sy)
        return parms.astype(np.int32)

    def _scan_consts(self, dev):
        return dict(xs=torch.arange(self._info.width, dtype=torch.int32,
                                    device=dev),
                    ys=torch.arange(self._info.height, dtype=torch.int32,
                                    device=dev))

    def _scan_step(self, carry, w, aux, k):
        wdt, hgt = self._info.width, self._info.height
        area = wdt * hgt
        dx, dy, sx, sy = (int(a) for a in aux)
        xs, ys = k["xs"], k["ys"]
        ox = (sx - ys[:, None] * dy) + xs[None, :] * dx
        oy = (sy + ys[:, None] * dx) + xs[None, :] * dy
        i = torch.clamp((oy >> 16) * wdt + (ox >> 16), 0, area)
        v = carry[i.long()] & 0xFCFCFF
        v = v * 3 + (w & 0xFCFCFF)
        out = (v >> 2) & 0xFFFFFF
        new_cur = torch.cat([out.reshape(-1), carry.new_zeros(1)])
        return new_cur, out


@register_element
class QuarkTV(_EffectvBase):
    FACTORY = "quarktv"
    DESCRIPTION = "Motion dissolver"
    PROPERTIES = {"planes": (int, 16, "number of history planes")}

    def _reset(self):
        if self._info is None:
            return
        n = int(self.props["planes"])
        area = self._info.width * self._info.height
        self._table = [None] * n
        self._current = n - 1
        self._rand_state = 0
        # LCG doubling ladder: (mul, add) of 2^j fastrand applications
        muls, adds = [], []
        m_, a_ = 1103515245, 12345
        for _ in range(area.bit_length() + 1):
            muls.append(m_)
            adds.append(a_)
            a_ = (m_ * a_ + a_) & M32
            m_ = (m_ * m_) & M32
        self._muls, self._adds = muls, adds

    def _frame(self, w):
        info = self._info
        area = info.width * info.height
        n = int(self.props["planes"])
        flat = w.reshape(-1)
        self._table[self._current] = flat.copy()
        # the C loop `while (--area)` draws area-1 fastrands for pixels
        # area-1 .. 1 (pixel 0 keeps the previous content; we use src)
        ks = np.arange(1, area, dtype=np.uint64)       # draw index per pix
        s = np.uint64(self._rand_state)
        # state after k draws: affine ladder
        mul = np.ones(area - 1, np.uint64)
        add = np.zeros(area - 1, np.uint64)
        k = (area - 1) - ks + 1   # pixel i=area-1 gets draw 1, i=1 gets area-1
        for bit, (m_, a_) in enumerate(zip(self._muls, self._adds)):
            sel = ((k >> np.uint64(bit)) & np.uint64(1)).astype(bool)
            add = np.where(sel, (np.uint64(a_) + np.uint64(m_) * add)
                           & np.uint64(M32), add)
            mul = np.where(sel, (mul * np.uint64(m_)) & np.uint64(M32), mul)
        states = (mul * s + add) & np.uint64(M32)
        sel_plane = ((np.uint64(self._current) + (states >> np.uint64(24)))
                     % np.uint64(n)).astype(np.int64)
        # advance the scalar state by area-1 draws
        m_f, a_f = lcg_affine(area - 1)
        self._rand_state = (m_f * int(s) + a_f) & M32

        out = flat.copy()
        idx = np.arange(1, area)
        for pl in range(n):
            tab = self._table[pl]
            if tab is None:
                continue
            m = sel_plane == pl
            out[idx[m]] = tab[idx[m]]
        self._current -= 1
        if self._current < 0:
            self._current = n - 1
        return out.reshape(info.height, info.width) & M32

    DEVICE_SCAN = True
    HOST_ELEMENT = False

    def _init_carry(self):
        n = int(self.props["planes"])
        area = self._info.width * self._info.height
        # per-pixel LCG affine ladder is static: state after k draws
        ks = np.arange(1, area, dtype=np.uint64)
        mul = np.ones(area - 1, np.uint64)
        add = np.zeros(area - 1, np.uint64)
        k = (area - 1) - ks + 1
        for bit, (m_, a_) in enumerate(zip(self._muls, self._adds)):
            sel = ((k >> np.uint64(bit)) & np.uint64(1)).astype(bool)
            add = np.where(sel, (np.uint64(a_) + np.uint64(m_) * add)
                           & np.uint64(M32), add)
            mul = np.where(sel, (mul * np.uint64(m_)) & np.uint64(M32), mul)
        self._mul_px = mul.astype(np.uint32)
        self._add_px = add.astype(np.uint32)
        m_f, a_f = lcg_affine(area - 1)
        self._adv = (np.uint32(m_f), np.uint32(a_f))
        return (np.zeros((n, area), np.int32),       # plane ring
                np.zeros(n, np.int32),                # filled flags
                np.int32(n - 1),                      # current
                np.uint32(0))                         # fastrand state

    def _scan_consts(self, dev):
        return dict(mul=torch.as_tensor(self._mul_px.astype(np.int64),
                                        device=dev),
                    add=torch.as_tensor(self._add_px.astype(np.int64),
                                        device=dev),
                    zero=torch.zeros(1, dtype=torch.int64, device=dev))

    def _scan_step(self, carry, w, aux, k):
        table, filled, current, rstate = carry
        info = self._info
        n = int(self.props["planes"])
        flat = w.reshape(-1)
        # the plane ring and its filled flags are this element's own
        # state: written in place
        table[current] = flat
        filled[current] = 1
        # the C fastrand per pixel, mod 2^32 in int64: mul * rstate split
        # in 16-bit halves so that no product leaves int64
        lo, hi = rstate & 0xFFFF, rstate >> 16
        states = (k["mul"] * lo + (((k["mul"] * hi) & 0xFFFF) << 16)
                  + k["add"]) & M32
        sel = torch.cat([k["zero"], (current + (states >> 24)) % n])
        gathered = table.gather(0, sel[None])[0]
        ok = torch.cat([k["zero"].bool(), filled[sel[1:]] != 0])
        out = torch.where(ok, gathered, flat)
        m_f, a_f = self._adv
        rstate = (int(m_f) * rstate + int(a_f)) & M32
        current = n - 1 if current - 1 < 0 else current - 1
        return ((table, filled, current, rstate),
                out.reshape(info.height, info.width) & 0xFFFFFF)


@register_element
class RevTV(_EffectvBase):
    FACTORY = "revtv"
    DESCRIPTION = "A video waveform monitor for each line of video"
    PROPERTIES = {
        "delay": (int, 1, "delay in frames"),
        "linespace": (int, 6, "control line spacing"),
        "gain": (int, 50, "control gain"),
    }

    def _frame(self, w):
        info = self._info
        wdt, hgt = info.width, info.height
        linespace = int(self.props["linespace"])
        vscale = int(self.props["gain"])
        out = np.zeros_like(w)
        for y in range(0, hgt, linespace):
            row = w[y]
            R = (row & 0xFF0000) >> 15
            G = (row & 0xFF00) >> 6
            B = row & 0xFF
            yval = y - ((R + G + B).astype(np.int64) // vscale)
            ok = yval > 0
            out[yval[ok], np.arange(wdt)[ok]] = 0xFFFFFFFF
        return out

    DEVICE_SCAN = True
    HOST_ELEMENT = False

    def _scan_consts(self, dev):
        rows = np.arange(0, self._info.height, int(self.props["linespace"]))
        return dict(rows=torch.as_tensor(rows, device=dev),
                    xs=torch.as_tensor(np.tile(np.arange(self._info.width),
                                               len(rows)), device=dev))

    def _scan_step(self, carry, w, aux, k):
        wdt = self._info.width
        vscale = int(self.props["gain"])
        rows = k["rows"]
        row = w[rows]                               # (nr, W)
        R = (row & 0xFF0000) >> 15
        G = (row & 0xFF00) >> 6
        B = row & 0xFF
        yval = rows[:, None] - torch.div(R + G + B, vscale,
                                         rounding_mode="floor")
        ok = yval > 0
        # every write stores the same value, so a scatter-max is
        # order-independent and equals the C's sequential writes
        idx = (torch.where(ok, yval, 0) * wdt).reshape(-1) + k["xs"]
        val = (ok.to(torch.int32) * 0xFFFFFF).reshape(-1)
        out = torch.zeros_like(w).reshape(-1).scatter_reduce(
            0, idx, val, "amax")
        return carry, out.reshape(w.shape)


@register_element
class DiceTV(_EffectvBase):
    """dicetv (gstdice.c): the frame is cut into cube_size squares, each
    statically rotated 0/90/180/270 per a fastrand map (:219)."""
    FACTORY = "dicetv"
    DESCRIPTION = "Dices the video into many small squares"
    PROPERTIES = {"square-bits": (int, 4, "log2 of square size")}

    def _reset(self):
        if self._info is None:
            return
        bits = int(self.props["square-bits"])
        self._cs = 1 << bits
        self._mw = self._info.width >> bits
        self._mh = self._info.height >> bits
        n = self._mw * self._mh
        s = 0
        vals = np.empty(n, np.int64)
        for i in range(n):
            s = (s * 1103515245 + 12345) & M32
            vals[i] = (s >> 24) & 0x03
        self._map = vals.reshape(self._mh, self._mw)

    def _frame(self, w):
        cs, mw, mh = self._cs, self._mw, self._mh
        out = w.copy()
        blocks = w[:mh * cs, :mw * cs].reshape(mh, cs, mw, cs)
        blocks = blocks.transpose(0, 2, 1, 3)          # (mh, mw, cs, cs)
        ob = blocks.copy()
        for rot, k in ((1, -1), (2, 2), (3, 1)):       # LEFT=cw, DOWN=180,
            m = self._map == rot                       # RIGHT=ccw
            if m.any():
                ob[m] = np.rot90(blocks[m], k=k, axes=(1, 2))
        out[:mh * cs, :mw * cs] = ob.transpose(0, 2, 1, 3).reshape(
            mh * cs, mw * cs)
        return out

    DEVICE_SCAN = True
    HOST_ELEMENT = False

    def _scan_consts(self, dev):
        # the dice map is static: the whole transform is one permutation
        cs, mw, mh = self._cs, self._mw, self._mh
        yy, xx = np.mgrid[0:mh * cs, 0:mw * cs]
        by, bx = yy // cs, xx // cs
        ly, lx = yy % cs, xx % cs
        rot = self._map[by, bx]
        sy = np.select([rot == 1, rot == 2, rot == 3],
                       [cs - 1 - lx, cs - 1 - ly, lx], ly)
        sx = np.select([rot == 1, rot == 2, rot == 3],
                       [ly, cs - 1 - lx, cs - 1 - ly], lx)
        return dict(iy=torch.as_tensor(by * cs + sy, device=dev),
                    ix=torch.as_tensor(bx * cs + sx, device=dev))

    def _scan_step(self, carry, w, aux, k):
        cs, mw, mh = self._cs, self._mw, self._mh
        out = w.clone()
        out[:mh * cs, :mw * cs] = w[k["iy"], k["ix"]]
        return carry, out


@register_element
class WarpTV(_EffectvBase):
    """warptv (gstwarp.c): sine-table based displacement warp; the last
    row stays unwritten (black) like the reference loop bound."""
    FACTORY = "warptv"
    DESCRIPTION = "WarpTV does realtime goo'ing of the video input"

    _SIN = None

    def _reset(self):
        if self._info is None:
            return
        wdt, hgt = self._info.width, self._info.height
        if WarpTV._SIN is None:
            t = np.array([int(math.sin(i * math.pi / 512) * 32767)
                          for i in range(1024)], np.int64)
            WarpTV._SIN = np.concatenate([t, t[:256]])
        halfw, halfh = wdt >> 1, hgt >> 1
        m = math.sqrt(halfw * halfw + halfh * halfh)
        ys = np.arange(-halfh, halfh, dtype=np.float64)[:, None]
        xs = np.arange(-halfw, halfw, dtype=np.float64)[None, :]
        self._dist = ((np.sqrt(xs * xs + ys * ys) * 511.9999 / m)
                      .astype(np.int64) << 1)
        self._tval = 0

    def _frame(self, w):
        wdt, hgt = self._info.width, self._info.height
        t = self._tval
        xw = int(math.sin((t + 100) * math.pi / 128) * 30)
        yw = int(math.sin(t * math.pi / 256) * -35)
        cw = int(math.sin((t - 70) * math.pi / 64) * 50)
        xw += int(math.sin((t - 10) * math.pi / 512) * 40)
        yw += int(math.sin((t + 30) * math.pi / 512) * 40)
        c = np.arange(512, dtype=np.int64) * cw
        i = (c >> 3) & 0x3FE
        ct_y = (WarpTV._SIN[i] * yw) >> 15           # ctable even entries
        ct_x = (WarpTV._SIN[i + 256] * xw) >> 15     # ctable odd entries
        ctable = np.empty(1024, np.int64)
        ctable[0::2] = ct_y
        ctable[1::2] = ct_x

        d = self._dist[:hgt - 1]                     # rows 0..h-2
        xs = np.arange(wdt, dtype=np.int64)[None, :]
        ys = np.arange(hgt - 1, dtype=np.int64)[:, None]
        dx = np.clip(ctable[d + 1] + xs, 0, wdt - 2)
        dy = np.clip(ctable[d] + ys, 0, hgt - 2)
        out = np.zeros_like(w)
        out[:hgt - 1] = w[dy, dx]
        self._tval = (t + 1) & 511
        return out

    DEVICE_SCAN = True
    HOST_ELEMENT = False
    HAS_AUX = True

    def scan_aux(self, batch: int):
        """Per-frame (xw, yw, cw): the tval counter and its sin() math
        run on the host exactly like the C."""
        parms = np.empty((batch, 3), np.int32)
        for k in range(batch):
            t = self._tval
            xw = int(math.sin((t + 100) * math.pi / 128) * 30)
            yw = int(math.sin(t * math.pi / 256) * -35)
            cw = int(math.sin((t - 70) * math.pi / 64) * 50)
            xw += int(math.sin((t - 10) * math.pi / 512) * 40)
            yw += int(math.sin((t + 30) * math.pi / 512) * 40)
            parms[k] = (xw, yw, cw)
            self._tval = (t + 1) & 511
        return parms

    def _scan_consts(self, dev):
        wdt, hgt = self._info.width, self._info.height
        d = self._dist[:hgt - 1]
        # gather indices into the 1024-entry ctable, clamped as a JAX
        # gather clamps (the distances stay below 1023 by construction)
        return dict(
            sin=torch.as_tensor(WarpTV._SIN.astype(np.int32), device=dev),
            c=torch.arange(512, dtype=torch.int32, device=dev),
            dy=torch.as_tensor(np.clip(d, 0, 1023), device=dev),
            dx=torch.as_tensor(np.clip(d + 1, 0, 1023), device=dev),
            xs=torch.arange(wdt, dtype=torch.int32, device=dev)[None, :],
            ys=torch.arange(hgt - 1, dtype=torch.int32, device=dev)[:, None])

    def _scan_step(self, carry, w, aux, k):
        wdt, hgt = self._info.width, self._info.height
        xw, yw, cw = (int(a) for a in aux)
        sin = k["sin"]
        i = (((k["c"] * cw) >> 3) & 0x3FE).long()
        ct_y = (sin[i] * yw) >> 15
        ct_x = (sin[i + 256] * xw) >> 15
        ctable = torch.stack([ct_y, ct_x], dim=-1).reshape(-1)
        dx = torch.clamp(ctable[k["dx"]] + k["xs"], 0, wdt - 2)
        dy = torch.clamp(ctable[k["dy"]] + k["ys"], 0, hgt - 2)
        out = torch.zeros_like(w)
        out[:hgt - 1] = w[dy.long(), dx.long()]
        return carry, out


@register_element
class RippleTV(_EffectvBase):
    """rippletv (gstripple.c): water-surface simulation refracting the
    image.  motion mode feeds luma deltas into the height map (:184);
    rain mode drops via the fastrand state machine (:248); wave
    propagation + lowpass stencils (:358-397), sqrtable refraction
    vectors (:405), 2x2 stretched refraction sampling (:418)."""
    FACTORY = "rippletv"
    DESCRIPTION = "RippleTV does ripple mark effect on the video input"
    PROPERTIES = {"mode": (str, "motion-detection", "motion-detection|rain")}

    _POINT, _IMPACT, _DECAY, _LOOPNUM = 16, 2, 8, 2

    def _reset(self):
        if self._info is None:
            return
        w, h = self._info.width, self._info.height
        self._mw, self._mh = w // 2 + 1, h // 2 + 1
        shape = (self._mh + 1, self._mw)
        self._map1 = np.zeros(shape, np.int64)
        self._map2 = np.zeros(shape, np.int64)
        self._bg = None
        self._rand = 0
        self._period = 0
        self._rain_stat = 0
        self._drop_prob = 0
        self._drop_prob_inc = 0
        self._drop_power = 0
        self._dpf_max = 0
        self._dpf = 0
        sq = np.zeros(256, np.int64)
        sq[:128] = np.arange(128) ** 2
        for i in range(1, 129):
            sq[256 - i] = -(i * i)
        self._sqrtable = sq

    def _fastrand(self):
        self._rand = (self._rand * 1103515245 + 12345) & M32
        return self._rand

    def _luma(self, w):
        return (((w & 0xFF0000) >> 15) + ((w & 0xFF00) >> 6) + (w & 0xFF))

    def _motiondetect(self, w):
        vw, vh = self._info.width, self._info.height
        lum = self._luma(w).astype(np.int64)
        if self._bg is None:
            self._bg = lum.copy()
        v = lum - self._bg
        self._bg = lum
        # diff = ((v + 490) >> 24) | ((490 - v) >> 24) as u8: 0xFF when
        # |v| exceeds the threshold band, else 0 (sign-bit trick)
        d = (((v + 490) >> 24) | ((490 - v) >> 24)) & 0xFF
        # 2x2 block sums at map cells (1..mh-2, 1..mw-2) from diff rows
        # starting at (1, 2) stepping 2 (pointer walk :202-219)
        mh, mw = self._mh, self._mw
        blk = np.zeros((mh + 1, mw), np.int64)
        ys = 1 + 2 * np.arange(mh - 2)[:, None]
        xs = 2 + 2 * np.arange(mw - 2)[None, :]
        hsum = (d[ys, xs] + d[ys, xs + 1]
                + d[ys + 1, xs] + d[ys + 1, xs + 1])
        m = hsum > 0
        val = hsum << (self._POINT + self._IMPACT - 8)
        sl = (slice(1, mh - 1), slice(1, mw - 1))
        self._map1[sl] = np.where(m, val, self._map1[sl])
        self._map2[sl] = np.where(m, val, self._map2[sl])

    def _drop(self, power):
        mw, mh = self._mw, self._mh
        x = self._fastrand() % (mw - 4) + 2
        y = self._fastrand() % (mh - 4) + 2
        for mp in (self._map1, self._map2):
            mp[y, x] = power
            half = power // 2 if power >= 0 else -((-power) // 2)
            quar = power // 4 if power >= 0 else -((-power) // 4)
            # C division truncates toward zero
            half = int(power / 2)
            quar = int(power / 4)
            mp[y - 1, x] = mp[y, x - 1] = mp[y, x + 1] = mp[y + 1, x] = half
            mp[y - 1, x - 1] = mp[y - 1, x + 1] = mp[y + 1, x - 1] = quar
            mp[y + 1, x + 1] = quar

    def _raindrop(self):
        if self._period == 0:
            st = self._rain_stat
            if st == 0:
                self._period = (self._fastrand() >> 23) + 100
                self._drop_prob = 0
                self._drop_prob_inc = 0x00FFFFFF // self._period
                self._drop_power = (-(self._fastrand() >> 28) - 2) \
                    << self._POINT
                self._dpf_max = 2 << (self._fastrand() >> 30)
                self._rain_stat = 1
            elif st == 1:
                self._drop_prob = 0x00FFFFFF
                self._dpf = 1
                self._drop_prob_inc = 1
                self._period = (self._dpf_max - 1) * 16
                self._rain_stat = 2
            elif st == 2:
                self._period = (self._fastrand() >> 22) + 1000
                self._drop_prob_inc = 0
                self._rain_stat = 3
            elif st == 3:
                self._period = (self._dpf_max - 1) * 16
                self._drop_prob_inc = -1
                self._rain_stat = 4
            elif st == 4:
                self._period = (self._fastrand() >> 24) + 60
                self._drop_prob_inc = -(self._drop_prob // self._period)
                self._rain_stat = 5
            else:
                self._period = (self._fastrand() >> 23) + 500
                self._drop_prob = 0
                self._rain_stat = 0
        st = self._rain_stat
        if st in (1, 5):
            if (self._fastrand() >> 8) < self._drop_prob:
                self._drop(self._drop_power)
            self._drop_prob += self._drop_prob_inc
        elif st in (2, 3, 4):
            for _ in range(self._dpf // 16):
                self._drop(self._drop_power)
            self._dpf += self._drop_prob_inc
        self._period -= 1

    def _frame(self, w):
        vw, vh = self._info.width, self._info.height
        mw, mh = self._mw, self._mh
        if self.props["mode"] == "rain":
            self._raindrop()
        else:
            self._motiondetect(w)

        inner = (slice(1, mh - 1), slice(1, mw - 1))
        for _ in range(self._LOOPNUM):
            p, q = self._map1, self._map2
            h = (p[0:mh - 2, 0:mw - 2] + p[0:mh - 2, 2:mw]
                 + p[2:mh, 0:mw - 2] + p[2:mh, 2:mw]
                 + p[0:mh - 2, 1:mw - 1] + p[1:mh - 1, 0:mw - 2]
                 + p[1:mh - 1, 2:mw] + p[2:mh, 1:mw - 1]
                 - p[inner] * 9) >> 3
            v = p[inner] - q[inner]
            v = v + h - (v >> self._DECAY)
            map3 = np.zeros_like(p)
            map3[inner] = v + p[inner]
            # low pass into map2
            q2 = np.zeros_like(p)
            q2[inner] = (map3[0:mh - 2, 1:mw - 1] + map3[1:mh - 1, 0:mw - 2]
                         + map3[1:mh - 1, 2:mw] + map3[2:mh, 1:mw - 1]
                         + map3[inner] * 60) >> 6
            # preserve untouched border cells of map2 (the C writes only
            # the interior)
            q2[0, :] = q[0, :]
            q2[-1, :] = q[-1, :]
            q2[:, 0] = q[:, 0]
            q2[:, -1] = q[:, -1]
            self._map1, self._map2 = q2, p

        p = self._map1
        sq = self._sqrtable
        # refraction vectors at (y, x) for y in 0..mh-2, x in 0..mw-2
        vp0 = np.zeros((mh, mw), np.int64)
        vp1 = np.zeros((mh, mw), np.int64)
        dx_id = ((p[:mh - 1, :mw - 1] - p[:mh - 1, 1:mw])
                 >> (self._POINT - 1)) & 0xFF
        dy_id = ((p[:mh - 1, :mw - 1] - p[1:mh, :mw - 1])
                 >> (self._POINT - 1)) & 0xFF
        vp0[:mh - 1, :mw - 1] = sq[dx_id]
        vp1[:mh - 1, :mw - 1] = sq[dy_id]

        ys = np.arange(0, vh, 2)[:, None]
        xs = np.arange(0, vw, 2)[None, :]
        my = ys // 2
        mx = xs // 2
        h0 = vp0[my, mx]
        v0 = vp1[my, mx]
        dx = np.clip(xs + h0, 0, vw - 2)
        dy = np.clip(ys + v0, 0, vh - 2)
        out = np.empty_like(w)
        out[0::2, 0::2] = w[dy, dx]
        h_next = vp0[my, mx + 1]
        # C integer division truncates toward zero
        s = h0 + h_next
        dx1 = np.clip(xs + 1 + np.sign(s) * (np.abs(s) // 2), 0, vw - 2)
        out[0::2, 1::2] = w[dy, dx1]
        v_next = vp1[my + 1, mx]
        s2 = v0 + v_next
        dy1 = np.clip(ys + 1 + np.sign(s2) * (np.abs(s2) // 2), 0, vh - 2)
        out[1::2, 0::2] = w[dy1, dx]
        out[1::2, 1::2] = w[dy1, dx1]
        return out


def _lcg_states_vec(state: int, n: int) -> np.ndarray:
    """States after 1..n fastrand draws from `state` (doubling ladder)."""
    muls, adds = [], []
    m_, a_ = 1103515245, 12345
    for _ in range(max(n.bit_length(), 1) + 1):
        muls.append(m_)
        adds.append(a_)
        a_ = (m_ * a_ + a_) & M32
        m_ = (m_ * m_) & M32
    k = np.arange(1, n + 1, dtype=np.uint64)
    mul = np.ones(n, np.uint64)
    add = np.zeros(n, np.uint64)
    for bit, (mm, aa) in enumerate(zip(muls, adds)):
        sel = ((k >> np.uint64(bit)) & np.uint64(1)).astype(bool)
        add = np.where(sel, (np.uint64(aa) + np.uint64(mm) * add)
                       & np.uint64(M32), add)
        mul = np.where(sel, (mul * np.uint64(mm)) & np.uint64(M32), mul)
    return ((mul * np.uint64(state) + add) & np.uint64(M32)).astype(np.int64)


@register_element
class AgingTV(_EffectvBase):
    """agingtv (gstaging.c): color aging (:93, per-pixel fastrand noise
    vectorized via the LCG ladder), scratches (:116), pits (:200),
    dusts (:164) — one shared fastrand state threaded through all stages
    in the reference call order (:336-345)."""
    FACTORY = "agingtv"
    DESCRIPTION = "AgingTV adds age to video input using scratches and dust"
    PROPERTIES = {
        "scratch-lines": (int, 7, "number of scratch lines"),
        "color-aging": (bool, True, ""),
        "pits": (bool, True, ""),
        "dusts": (bool, True, ""),
    }

    _DX = [1, 1, 0, -1, -1, -1, 0, 1]
    _DY = [0, -1, -1, -1, 0, 1, 1, 1]

    def _reset(self):
        if self._info is None:
            return
        self._rand = 0
        self._coloraging_state = 0
        self._scratches = [dict(life=0, x=0, dx=0, init=0)
                           for _ in range(20)]
        self._pits_interval = 0
        self._dust_interval = 0

    def _fastrand(self):
        self._rand = (self._rand * 1103515245 + 12345) & M32
        return self._rand

    def _frame(self, w):
        wdt, hgt = self._info.width, self._info.height
        area = wdt * hgt
        area_scale = max(wdt * hgt // 64 // 480, 1)
        dest = w.copy()

        if self.props["color-aging"]:
            c = self._coloraging_state
            r0 = self._fastrand()
            # c -= (gint)fastrand() >> 28 (arithmetic shift of SIGNED)
            sr = r0 - (1 << 32) if r0 >= (1 << 31) else r0
            c -= sr >> 28
            c = min(max(c, 0), 0x18)
            states = _lcg_states_vec(self._rand, area).reshape(hgt, wdt)
            self._rand = int(states[-1, -1])
            noise = (states >> 8) & 0x101010
            a = w
            b = (a & 0xFCFCFC) >> 2
            dest = (a - b + (c | (c << 8) | (c << 16)) + noise) & M32
            self._coloraging_state = c

        # scratches (:116) — per-line state, sequential but tiny
        n_lines = int(self.props["scratch-lines"])
        for s in self._scratches[:n_lines]:
            if s["life"]:
                s["x"] += s["dx"]
                if s["x"] < 0 or s["x"] > wdt * 256:
                    s["life"] = 0
                    break
                px = s["x"] >> 8
                y1 = s["init"] or 0
                s["init"] = 0
                s["life"] -= 1
                if s["life"]:
                    y2 = hgt
                else:
                    y2 = self._fastrand() % hgt
                col = dest[y1:y2, px]
                a = (col & 0xFEFEFF) + 0x202020
                b = a & 0x1010100
                dest[y1:y2, px] = a | (b - (b >> 8))
            else:
                if (self._fastrand() & 0xF0000000) == 0:
                    s["life"] = 2 + (self._fastrand() >> 27)
                    s["x"] = self._fastrand() % (wdt * 256)
                    r = self._fastrand()
                    s["dx"] = (r - (1 << 32) if r >= (1 << 31) else r) >> 23
                    s["init"] = (self._fastrand() % (hgt - 1)) + 1

        if self.props["pits"]:
            pnumscale = area_scale * 2
            if self._pits_interval:
                pnum = pnumscale + (self._fastrand() % pnumscale)
                self._pits_interval -= 1
            else:
                pnum = self._fastrand() % pnumscale
                if (self._fastrand() & 0xF8000000) == 0:
                    self._pits_interval = (self._fastrand() >> 28) + 20
            for _i in range(pnum):
                x = self._fastrand() % (wdt - 1)
                y = self._fastrand() % (hgt - 1)
                size = self._fastrand() >> 28
                for _j in range(size):
                    x = (x + self._fastrand() % 3 - 1) & M32
                    y = (y + self._fastrand() % 3 - 1) & M32
                    if y >= hgt or x >= wdt:
                        break
                    dest[y, x] = 0xC0C0C0

        if area_scale > 1 and self.props["dusts"]:
            if self._dust_interval == 0:
                if (self._fastrand() & 0xF0000000) == 0:
                    self._dust_interval = self._fastrand() >> 29
            else:
                dnum = area_scale * 4 + (self._fastrand() >> 27)
                for _i in range(dnum):
                    x = self._fastrand() % wdt
                    y = self._fastrand() % hgt
                    d = self._fastrand() >> 29
                    ln = self._fastrand() % area_scale + 5
                    for _j in range(ln):
                        dest[y, x] = 0x101010
                        y = (y + self._DY[d]) & M32
                        x = (x + self._DX[d]) & M32
                        if y >= hgt or x >= wdt:
                            break
                        d = (d + self._fastrand() % 3 - 1) & 7
                self._dust_interval -= 1

        return dest & M32


@register_element
class OpTV(_EffectvBase):
    """optv (gstop.c): op-art palette mapping — phase-shifted pattern
    maps (spiral/parabola/hstripe :139-181) XOR a luma threshold mask
    (:184), looked up in the 256-entry palette (:121)."""
    FACTORY = "optv"
    DESCRIPTION = "Optical art meets real-time video effect"
    PROPERTIES = {
        "mode": (int, 0, "0=maelstrom 1=radiation 2=perspective 3=vertical"),
        "speed": (int, 16, "effect speed"),
        "threshold": (int, 60, "luma threshold"),
    }

    _PALETTE = None

    def _reset(self):
        if self._info is None:
            return
        if OpTV._PALETTE is None:
            pal = np.zeros(256, np.int64)
            pal[128:240] = 0xFFFFFF
            for i in range(16):
                v = 16 * (i + 1) - 1
                pal[i + 112] = (v << 16) | (v << 8) | v
                v2 = 255 - v
                pal[i + 240] = (v2 << 16) | (v2 << 8) | v2
            OpTV._PALETTE = pal
        wdt, hgt = self._info.width, self._info.height
        sci = 640 // wdt if wdt else 1
        ys = np.arange(hgt)[:, None]
        xs = np.arange(wdt)[None, :]
        yy = (ys - hgt // 2) / wdt
        xx = xs / wdt - 0.5
        yy = yy + np.zeros_like(xx)
        xx = xx + np.zeros((hgt, 1))
        r = np.sqrt(xx * xx + yy * yy)
        at = np.arctan2(xx, yy)
        maps = {}
        maps[0] = (at / math.pi * 256 + r * 4000).astype(np.int64) & 255
        j = (r * 300 / 32).astype(np.int64)
        rr = r * 300 - j * 32
        j = j * 64 + np.where(rr > 28, ((rr - 28) * 16).astype(np.int64), 0)
        maps[1] = (at / math.pi * 4096 + r * 1600 - j).astype(np.int64) & 255
        maps[2] = (yy / (xx * xx * 0.3 + 0.1) * 400).astype(np.int64) & 255
        maps[3] = (xs * 8 * sci + np.zeros((hgt, 1), np.int64)) & 255
        # gint8 semantics: the map is stored as signed bytes
        self._maps = {k: np.where(v >= 128, v - 256, v)
                      for k, v in maps.items()}
        self._phase = 0

    def _frame(self, w):
        p = self._maps[int(self.props["mode"]) & 3]
        self._phase = (self._phase - int(self.props["speed"]))
        lum = (((w & 0xFF0000) >> 15) + ((w & 0xFF00) >> 6) + (w & 0xFF))
        v = int(self.props["threshold"]) * 7 - lum
        diff = (v >> 24) & 0xFF      # (guint8)(v >> 24): 0 or 0xFF
        idx = (((p + self._phase) & 0xFF) ^ diff) & 255
        return OpTV._PALETTE[idx]


@register_element
class RadioacTV(_EffectvBase):
    """radioactv (gstradioac.c): motion-triggered radioactive glow via a
    blur+zoom feedback buffer (:232,:261), palette add (:397-406).
    Geometry quirks ported verbatim: blur offsets by the FRAME width
    (:243), buf_margin_right computed from the HEIGHT (:441)."""
    FACTORY = "radioactv"
    DESCRIPTION = "motion-enlightment effect"
    PROPERTIES = {
        "mode": (int, 0, "0=normal 1=strobe 2=strobe2 3=trigger"),
        "color": (int, 3, "0=red 1=green 2=blue 3=white"),
        "interval": (int, 3, "snapshot interval (strobe)"),
        "trigger": (bool, False, "trigger (mode 3)"),
    }

    _COLORS, _PATTERN, _THRESH, _RATIO = 32, 4, 40, 0.95
    _PALETTES = None

    def _reset(self):
        if self._info is None:
            return
        if RadioacTV._PALETTES is None:
            C = self._COLORS
            delta = 255 // (C // 2 - 1)
            pal = np.zeros(C * 4, np.int64)
            for i in range(C // 2):
                pal[i] = i * delta
                pal[C + i] = (i * delta) << 8
                pal[2 * C + i] = (i * delta) << 16
                pal[i + C // 2] = 255 | ((i * delta) << 16) | ((i * delta) << 8)
                pal[C + i + C // 2] = (255 << 8) | ((i * delta) << 16) \
                    | (i * delta)
                pal[2 * C + i + C // 2] = (255 << 16) | ((i * delta) << 8) \
                    | (i * delta)
            for i in range(C):
                pal[3 * C + i] = (255 * i // C) * 0x10101
            RadioacTV._PALETTES = pal & 0xFEFEFF
        w, h = self._info.width, self._info.height
        self._bwb = min(w // 32, 255)
        self._bw = self._bwb * 32
        self._bh = h
        self._area = self._bw * self._bh
        self._ml = (w - self._bw) // 2
        self._mr = max(h - self._bw - self._ml, 0)   # (:441 height quirk)
        self._buf = np.zeros(2 * self._area + 2 * w, np.int64)
        self._bg = None
        self._snap = None
        self._snaptime = 0
        # zoom tables (:196)
        R = self._RATIO
        hw, hh = self._bw // 2, self._bh // 2
        bits = np.zeros(self._bw, np.int64)
        prev = int(0.5 + R * (-hw) + hw)
        for i in range(self._bw):
            ptr = int(0.5 + R * (i - hw) + hw)
            bits[i] = 1 if ptr != prev else 0
            prev = ptr
        zy = np.zeros(self._bh, np.int64)
        ty = int(0.5 + R * (-hh) + hh)
        tx = int(0.5 + R * (-hw) + hw)
        xx = int(0.5 + R * (self._bw - 1 - hw) + hw)
        zy[0] = ty * self._bw + tx
        prevptr = ty * self._bw + xx
        for y in range(1, self._bh):
            ty = int(0.5 + R * (y - hh) + hh)
            zy[y] = ty * self._bw + tx - prevptr
            prevptr = ty * self._bw + xx
        # absolute gather indices: p starts at area and advances by
        # blurzoomy[y] at each row then by bit per pixel (pre-increment)
        cum_bits = np.cumsum(bits)
        total = int(cum_bits[-1])
        row_start = self._area + np.cumsum(zy) + np.arange(self._bh) * total
        self._zoom_idx = (row_start[:, None] + cum_bits[None, :]).astype(
            np.int64)

    def _frame(self, w):
        info = self._info
        wdt, hgt = info.width, info.height
        mode = int(self.props["mode"])
        pal_idx = [2, 1, 0, 3][int(self.props["color"])]  # BGRx swap_tab
        palette = RadioacTV._PALETTES[
            self._COLORS * pal_idx:self._COLORS * (pal_idx + 1)]

        if mode == 3:
            self._snaptime = 0 if self.props["trigger"] else 1

        src = w
        if mode != 2 or self._snaptime <= 0:
            lum = (((w & 0xFF0000) >> 15) + ((w & 0xFF00) >> 6)
                   + (w & 0xFF)).astype(np.int64)
            if self._bg is None:
                self._bg = np.zeros_like(lum)
            v = lum - self._bg
            self._bg = lum
            th = self._THRESH * 7
            diff = (((v + th) >> 24) | ((th - v) >> 24)) & 0xFF
            if mode == 0 or self._snaptime <= 0:
                d = diff[:, self._ml:self._ml + self._bw]
                buf2d = self._buf[:self._area].reshape(self._bh, self._bw)
                buf2d |= d >> 3
                if mode in (1, 2):
                    self._snap = w.copy()

        # blur (:232): offsets use the FRAME width
        buf = self._buf
        fw = wdt
        p0 = fw + 1
        n = (self._bh - 2) * self._bw  # walk length approximation via 2D
        first = buf[:self._area + 2 * fw]
        # emulate the pointer walk on the flat buffer exactly
        bw = self._bw
        pidx = p0 + (np.arange(self._bh - 2)[:, None] * bw
                     + np.arange(bw - 2)[None, :])
        v = (buf[pidx - bw] + buf[pidx - 1] + buf[pidx + 1]
             + buf[pidx + bw]) // 4 - 1
        v = np.where((v & 0xFF) == 255, 0, v & 0xFF)
        buf[self._area + p0
            + (np.arange(self._bh - 2)[:, None] * bw
               + np.arange(bw - 2)[None, :])] = v.reshape(self._bh - 2,
                                                          bw - 2)
        # zoom (:261)
        buf[:self._area] = buf[self._zoom_idx].reshape(-1)

        if mode in (1, 2) and self._snap is not None:
            src = self._snap
        out = src.copy()
        glow = palette[buf[:self._area].reshape(self._bh, self._bw)
                       & (self._COLORS - 1)]
        sl = (slice(None), slice(self._ml, self._ml + self._bw))
        a = (src[sl] & 0xFEFEFF) + glow
        b = a & 0x1010100
        out[sl] = a | (b - (b >> 8))

        if mode in (1, 2):
            self._snaptime -= 1
            if self._snaptime < 0:
                self._snaptime = int(self.props["interval"])
        return out & M32
