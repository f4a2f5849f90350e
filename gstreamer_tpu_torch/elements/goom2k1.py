"""goom2k1 — the classic goom audio visualizer (2001 version).

Port of gst-plugins-good/gst/goom2k1/ (goom_core.c, filters.c,
lines.c, graphic.c, gstgoom.c):
* sound study: speedvar/accelvar dynamics from the 512-sample peak
  (goom_core.c:102-125), "goom" detection against an adaptive
  goomlimit, mode/center/plane-effect shuffles on the exact iRAND
  decision ladder (goom_core.c:168-331);
* the zoom filter: per-pixel (px,py) source maps for
  WAVE/CRYSTAL_BALL/AMULETTE/SCRUNCH/WATER modes in 1/16-pixel fixed
  point (filters.c calculatePXandPY :107-208), applied as a 4-tap
  bilinear gather with sqrtperte=16 sub-pixel coefficients
  (filters.c:480-509) — vectorized into numpy gathers (the job the
  reference gives its MMX/AltiVec kernels). The coefficient tables
  start calloc-zeroed (filters.c:285) so frames before the first
  zfd_update render black, as upstream does;
* the 5-dot pointFilter orbits (filters.c:514-531) and the stereo
  lines/circles overlays (lines.c:27-113, including lighten() applied
  to BYTES 1..3 of the little-endian color word only);
* sintable quirks kept: the typo'd period 3.31415 (not 2*pi) and
  entry 0xFFFF never written by the fill loop (static-zero)
  (filters.c:296-301).

Deviations (documented): the reference seeds its 65536-entry RNG
table from libc rand() (nondeterministic; goom_tools.h) and reads
UNINITIALIZED malloc'd memory for the WATER-mode firedec table
(filters.c:327 allocates, nothing fills it); here the table is
seeded deterministically (`seed` property), firedec is zero-filled,
and the one libc `rand () % 3` call (goom_core.c:224) draws from the
same table. Out-of-frame line plots are skipped instead of
corrupting memory.

Emits xRGB words ((r<<16)|(g<<8)|b) through the AudioVisualizer base
(same word layout as setPixelRGB_, filters.c:249).

A copy of the JAX package's ``elements/goom2k1.py`` on the port's
AudioVisualizerElement (host rasteriser, one upload a tick).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.element import register_element
from .visualizers import AudioVisualizerElement

STOP_SPEED = 128
EFFECT_DISTORS = 10
NB_RAND = 0x10000

WAVE_MODE, CRYSTAL_BALL_MODE, SCRUNCH_MODE, AMULETTE_MODE, \
    WATER_MODE, NORMAL_MODE = 0, 1, 2, 3, 4, 5

# graphic.c:7-14 — Color {r, v, b}
_YELLOW = (0xFF, 0xFF, 0x33)
_ORANGE = (0xFF, 0xCC, 0x00)
_VIOLET = (0x55, 0x00, 0xFF)
_BLACK = (0, 0, 0)
_WHITE = (0xFF, 0xFF, 0xFF)


def _make_sintable() -> np.ndarray:
    """filters.c:296-301 — float32 arg chain, entry 0xFFFF stays 0."""
    t = np.zeros(0x10000, np.int64)
    for us in range(0xFFFF):
        arg = np.float32(np.float32(us * 2) * np.float32(3.31415)) \
            / np.float32(0xFFFF)
        t[us] = int(1024.0 * math.sin(float(arg)))
    return t


_SINTABLE = _make_sintable()


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // b
    return -q if a < 0 else q


def _rgb(c) -> int:
    r, v, b = c
    return (r << 16) | (v << 8) | b


def _lighten(value: int, power: int) -> int:
    """lines.c:17-25 (unsigned char arithmetic)."""
    for _ in range(power):
        value = (value + (255 - value) // 5) & 0xFF
    return value


def _lighten_word(color: int, power: int) -> int:
    """lines.c:57-66: lighten bytes 1,2,3 of the little-endian word
    (byte 0 — blue — is left untouched; the top byte IS lightened)."""
    b0 = color & 0xFF
    b1 = _lighten((color >> 8) & 0xFF, power)
    b2 = _lighten((color >> 16) & 0xFF, power)
    b3 = _lighten((color >> 24) & 0xFF, power)
    return (b3 << 24) | (b2 << 16) | (b1 << 8) | b0


class GoomState:
    """goom_init state (goom_core.c:39-66) + zoom filter tables."""

    def __init__(self, w: int, h: int, seed: int = 0):
        self.w, self.h = w, h
        # slack row + 2 words: the 4-tap gather reads pos+w+1 where
        # pos can be (w-1)+w*(h-1) for in-range maps — the C buffers
        # have exactly w*h words and rely on pos10 bounds; we keep
        # real slack so vectorized gathers never fault.
        self.p1 = np.zeros(w * h + w + 2, np.uint32)
        self.p2 = np.zeros(w * h + w + 2, np.uint32)
        rng = np.random.default_rng(seed)
        self.rand_tab = rng.integers(0, 2 ** 31, NB_RAND, dtype=np.int64)
        self.rand_pos = 0
        self.cycle = 0
        self.goomlimit = 2              # goom_core.c:58
        self.lockvar = self.goomvar = self.totalgoom = 0
        self.agoom = self.loopvar = self.speedvar = 0
        self.lineMode = 0
        # zoomFilterNew defaults (filters.c:62-89)
        self.zf = dict(vitesse=128, pertedec=8, sqrtperte=16,
                       middleX=w // 2, middleY=h - 1, reverse=0,
                       mode=WAVE_MODE, hPlaneEffect=0, vPlaneEffect=0,
                       noisify=0, wave=0, wavesp=0)
        # reference: malloc'd, never initialized (filters.c:327)
        self.firedec = np.zeros(h, np.int64)
        # reference: calloc'd (filters.c:285) — black until 1st update
        self.pos10 = np.zeros(w * h, np.int64)
        self.coefs = np.zeros((4, w * h), np.int64)

    # -- RNG table walk (goom_tools.h RAND/iRAND) --------------------------
    def rand(self) -> int:
        self.rand_pos = (self.rand_pos + 1) % NB_RAND
        return int(self.rand_tab[self.rand_pos])

    def irand(self, n: int) -> int:
        return self.rand() % n

    def rand_block(self, n: int) -> np.ndarray:
        """n sequential draws, vectorized (same table order as n
        scalar RAND() calls)."""
        idx = (self.rand_pos + 1 + np.arange(n)) % NB_RAND
        self.rand_pos = (self.rand_pos + n) % NB_RAND
        return self.rand_tab[idx]

    # -- zoom map (filters.c calculatePXandPY, vectorized) -----------------
    def _gen_map(self) -> None:
        zf = self.zf
        w, h = self.w, self.h
        yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
        vit = zf["vitesse"]
        if zf["mode"] == WATER_MODE:
            px = np.zeros((h, w), np.int64)
            py = np.zeros((h, w), np.int64)
            wave, wavesp = zf["wave"], zf["wavesp"]
            pyc = 132 - (vit if vit < 132 else 131)
            for y in range(h):
                for x in range(w):
                    yv = y + self.irand(4) + _tdiv(wave, 10)
                    yv -= self.irand(4)
                    yv = min(max(yv, 0), h - 1)
                    px[y, x] = (x << 4) + int(self.firedec[yv]) \
                        + _tdiv(wave, 10)
                    py[y, x] = (y << 4) + pyc
                    wavesp += self.irand(3)
                    wavesp -= self.irand(3)
                    if wave < -10:
                        wavesp += 2
                    if wave > 10:
                        wavesp -= 2
                    wave += _tdiv(wavesp, 10) + self.irand(3)
                    wave -= self.irand(3)
                    if wavesp > 100:
                        wavesp = _tdiv(wavesp * 9, 10)
            zf["wave"], zf["wavesp"] = wave, wavesp
        else:
            mx, my = zf["middleX"], zf["middleY"]
            x, y = xx, yy
            if zf["noisify"]:
                n = zf["noisify"]
                d = self.rand_block(4 * w * h).reshape(h, w, 4)
                x = x + d[..., 0] % n - d[..., 1] % n
                y = y + d[..., 2] % n - d[..., 3] % n
            hP, vP = zf["hPlaneEffect"], zf["vPlaneEffect"]
            vx = ((x - mx) << 9) + (hP * (y - my) if hP else 0)
            vy = ((y - my) << 9) + (vP * (x - mx) if vP else 0)

            def sr(v, k):                       # ShiftRight: sign-aware
                return np.where(v < 0, -((-v) >> k), v >> k)

            fvit = np.full((h, w), vit << 4, np.int64)
            mode = zf["mode"]
            if mode in (WAVE_MODE, CRYSTAL_BALL_MODE, AMULETTE_MODE,
                        SCRUNCH_MODE):
                dist = sr(vx, 9) ** 2 + sr(vy, 9) ** 2
                if mode == WAVE_MODE:
                    idx = (0xFFFF * dist * EFFECT_DISTORS) & 0xFFFF
                    s = _SINTABLE[idx]
                    fvit = (fvit * (1024 + sr(s, 6))) // 1024
                elif mode == CRYSTAL_BALL_MODE:
                    fvit = fvit + ((dist * EFFECT_DISTORS) >> 10)
                elif mode == AMULETTE_MODE:
                    fvit = fvit - ((dist * EFFECT_DISTORS) >> 4)
                else:                            # SCRUNCH
                    fvit = fvit - ((dist * EFFECT_DISTORS) >> 9)
            prod_x = vx * fvit
            prod_y = vy * fvit
            px = np.where(vx < 0, (mx << 4) - ((-prod_x) >> 16),
                          (mx << 4) + (prod_x >> 16))
            py = np.where(vy < 0, (my << 4) - ((-prod_y) >> 16),
                          (my << 4) + (prod_y >> 16))

        # self-map nudge + bounds (zoomFilterFastRGB :404-457)
        same = (px == (xx << 4)) & (py == (yy << 4))
        py = np.where(same, py + 8, py)
        sq = self.zf["sqrtperte"]
        bad = (px < 0) | (py < 0) | (px >= (w - 1) * sq) \
            | (py >= (h - 1) * sq)
        npx10 = np.where(bad, 0, px // sq)
        npy10 = np.where(bad, 0, py // sq)
        coefh = np.where(bad, 0, px % sq)
        coefv = np.where(bad, 0, py % sq)
        c0 = np.where((coefh == 0) & (coefv == 0), sq * sq - 1,
                      (sq - coefh) * (sq - coefv))
        self.pos10 = np.where(bad, 0, npx10 + w * npy10).ravel()
        self.coefs = np.stack([
            np.where(bad, 0, c0).ravel(),
            np.where(bad, 0, coefh * (sq - coefv)).ravel(),
            np.where(bad, 0, (sq - coefh) * coefv).ravel(),
            np.where(bad, 0, coefh * coefv).ravel()])

    def _zoom_apply(self) -> None:
        """filters.c:480-509 — vectorized 4-tap gather p1 -> p2."""
        w, h = self.w, self.h
        n = w * h
        pix1 = self.p1
        pos = self.pos10
        cols = (pix1[pos], pix1[pos + 1], pix1[pos + w],
                pix1[pos + w + 1])
        out = np.zeros(n, np.uint32)
        per = self.zf["pertedec"]
        for shift in (16, 8, 0):
            acc = np.zeros(n, np.int64)
            for c, col in zip(self.coefs, cols):
                acc += ((col >> np.uint32(shift)) & 0xFF).astype(np.int64) * c
            out |= ((acc >> per) & 0xFF).astype(np.uint32) \
                << np.uint32(shift)
        self.p2[:n] = out

    # -- pointFilter (filters.c:514-531) -----------------------------------
    def _point_filter(self, color, t1, t2, t3, t4, cycle) -> None:
        zf = self.zf
        w, h = self.w, self.h
        x = zf["middleX"] + int(t1 * math.cos(cycle / t3))
        y = zf["middleY"] + int(t2 * math.sin(cycle / t4))
        if 1 < x < w - 2 and 1 < y < h - 2:
            p = self.p1
            c = _rgb(color)
            p[y * w + x + 1] = c
            p[(y + 1) * w + x] = c
            p[(y + 1) * w + x + 1] = _rgb(_WHITE)
            p[(y + 1) * w + x + 2] = c
            p[(y + 2) * w + x + 1] = c

    # -- goom_lines (lines.c:27-113) ---------------------------------------
    def _lines(self, data: np.ndarray, line_id: int, power: int) -> None:
        w, h = self.w, self.h
        p = self.p2
        if line_id == 0:
            col1 = _lighten_word(0x0000AA00, power)
            col2 = _lighten_word(0x00AA0000, power)
            i = np.arange(512, dtype=np.int64)
            d0 = np.array([_tdiv(int(v), 1600) for v in data[0]],
                          np.int64)
            d1 = np.array([_tdiv(int(v), 1600) for v in data[1]],
                          np.int64)
            plot1 = i * w // 512 + (h // 4 + d0) * w
            plot2 = i * w // 512 + (h * 3 // 4 - d1) * w
            ok1 = (plot1 >= 0) & (plot1 < w * h - 1)
            ok2 = (plot2 >= 0) & (plot2 < w * h - 1)
            p[plot1[ok1]] = col1
            p[plot1[ok1] + 1] = col1
            p[plot2[ok2]] = col2
            p[plot2[ok2] + 1] = col2
        else:
            col1 = _lighten_word(0x00AA33DD, power)
            col2 = _lighten_word(0x00AA33DD, power)
            monX = w // 2
            monY = float(h) / 4.0
            monY2 = float(h) / 2.0
            z = np.float32(0.0)
            step = np.float32(1.0) / np.float32(monY)
            while z < np.float32(6.2832):
                k = int(z * np.float32(81.33))
                d1 = int(data[1][min(k, 511)])
                d0 = int(data[0][min(k, 511)])
                off1 = monX + int(
                    (monY + h * (128 + d1) / 200000.0) * math.cos(z)
                    + w * int(monY2 + (monY + h * (128 + d1)
                                       / 400000.0) * math.sin(z)))
                off2 = monX + int(
                    (monY - h * (128 + d0) / 200000.0) * math.cos(z)
                    + w * int(monY2 + (monY - h * (128 + d0)
                                       / 400000.0) * math.sin(z)))
                if 0 <= off1 < w * h:
                    p[off1] = col1
                if 0 <= off2 < w * h:
                    p[off2] = col2
                z = np.float32(z + step)

    # -- goom_update (goom_core.c:80-410) ----------------------------------
    def update(self, data: np.ndarray) -> np.ndarray:
        zf = self.zf
        w, h = self.w, self.h
        point_w = (w * 2) // 5
        point_h = (h * 2) // 5

        incvar = max(0, int(data[0].max(initial=0)))
        accelvar = incvar // 5000
        if self.speedvar > 5:
            accelvar -= 1
            if self.speedvar > 20:
                accelvar -= 1
            if self.speedvar > 40:
                self.speedvar = 40
        accelvar -= 1
        self.speedvar = min(max(self.speedvar + accelvar, 0), 40)

        largfactor = min((self.speedvar / 40.0 + incvar / 50000.0)
                         / 1.5, 1.5)
        zfd_update = False

        i = 1
        while i * 15 <= self.speedvar + 15:
            self.loopvar += self.speedvar + 1
            self._point_filter(
                _YELLOW,
                (point_w - 6.0) * largfactor + 5.0,
                (point_h - 6.0) * largfactor + 5.0,
                i * 152.0, 128.0, self.loopvar + i * 2032)
            self._point_filter(
                _ORANGE,
                ((point_w // 2) * largfactor) / i + 10.0 * i,
                ((point_h // 2) * largfactor) / i + 10.0 * i,
                96.0, i * 80.0, self.loopvar // i)
            self._point_filter(
                _VIOLET,
                ((point_h // 3 + 5.0) * largfactor) / i + 10.0 * i,
                ((point_h // 3 + 5.0) * largfactor) / i + 10.0 * i,
                i + 122.0, 134.0, self.loopvar // i)
            self._point_filter(
                _BLACK,
                (point_h // 3) * largfactor + 20.0,
                (point_h // 3) * largfactor + 20.0,
                58.0, i * 66.0, self.loopvar // i)
            self._point_filter(
                _WHITE,
                (point_h * largfactor + 10.0 * i) / i,
                (point_h * largfactor + 10.0 * i) / i,
                66.0, 74.0, self.loopvar + i * 500)
            i += 1

        self.lockvar = max(self.lockvar - 1, 0)
        self.agoom = max(self.agoom - 1, 0)

        goomed = accelvar > self.goomlimit or accelvar < -self.goomlimit
        if goomed:
            self.totalgoom += 1
            self.agoom = 20
            self.lineMode = (self.lineMode + 1) % 20
            r = self.irand(10)
            if r in (0, 1, 2):
                zf["mode"] = WAVE_MODE
                zf["vitesse"] = STOP_SPEED - 1
                zf["reverse"] = 0
            elif r in (3, 4):
                zf["mode"] = CRYSTAL_BALL_MODE
            elif r == 5:
                zf["mode"] = AMULETTE_MODE
            elif r == 6:
                zf["mode"] = WATER_MODE
            elif r == 7:
                zf["mode"] = SCRUNCH_MODE
            else:
                zf["mode"] = NORMAL_MODE

        if self.lockvar == 0:
            if goomed:
                self.goomvar += 1
                newvit = STOP_SPEED - self.speedvar // 2
                if zf["reverse"] and not (self.cycle % 12) \
                        and self.irand(3) == 0:
                    zf["reverse"] = 0
                    zf["vitesse"] = STOP_SPEED - 2
                    self.lockvar = 50
                if self.irand(10) == 0:
                    zf["reverse"] = 1
                    self.lockvar = 100
                r = self.irand(20)
                if r == 0:
                    zf["middleY"] = h - 1
                    zf["middleX"] = w // 2
                elif r == 1:
                    zf["middleX"] = w - 1
                elif r == 2:
                    zf["middleX"] = 1
                else:
                    zf["middleY"] = h // 2
                    zf["middleX"] = w // 2
                if zf["mode"] == WATER_MODE:
                    zf["middleX"] = w // 2
                    zf["middleY"] = h // 2
                vtmp = self.irand(27)
                if vtmp == 0:
                    zf["vPlaneEffect"] = self.irand(3)
                    zf["vPlaneEffect"] -= self.irand(3)
                    zf["hPlaneEffect"] = self.irand(3)
                    zf["hPlaneEffect"] -= self.irand(3)
                elif vtmp == 3:
                    zf["vPlaneEffect"] = 0
                    zf["hPlaneEffect"] = self.irand(8)
                    zf["hPlaneEffect"] -= self.irand(8)
                elif vtmp in (4, 5, 6, 7):
                    zf["vPlaneEffect"] = self.irand(5)
                    zf["vPlaneEffect"] -= self.irand(5)
                    zf["hPlaneEffect"] = -zf["vPlaneEffect"]
                elif vtmp == 8:
                    zf["hPlaneEffect"] = 5 + self.irand(8)
                    zf["vPlaneEffect"] = -zf["hPlaneEffect"]
                elif vtmp == 9:
                    zf["vPlaneEffect"] = 5 + self.irand(8)
                    # reference bug kept: negates the OLD hPlaneEffect
                    zf["hPlaneEffect"] = -zf["hPlaneEffect"]
                elif vtmp == 13:
                    zf["hPlaneEffect"] = 0
                    zf["vPlaneEffect"] = self.irand(10)
                    zf["vPlaneEffect"] -= self.irand(10)
                elif vtmp < 10:
                    zf["vPlaneEffect"] = 0
                    zf["hPlaneEffect"] = 0
                if self.irand(3) != 0:
                    zf["noisify"] = 0
                else:
                    zf["noisify"] = self.irand(3) + 2
                    self.lockvar *= 3
                if zf["mode"] == AMULETTE_MODE:
                    zf["vPlaneEffect"] = 0
                    zf["hPlaneEffect"] = 0
                    zf["noisify"] = 0
                if zf["middleX"] in (1, w - 1):
                    zf["vPlaneEffect"] = 0
                    zf["hPlaneEffect"] = (0 if self.irand(2)
                                          else zf["hPlaneEffect"])
                if newvit < zf["vitesse"]:
                    zfd_update = True
                    if ((newvit < STOP_SPEED - 7
                         and zf["vitesse"] < STOP_SPEED - 6
                         and self.cycle % 3 == 0)
                            or self.irand(40) == 0):
                        zf["vitesse"] = STOP_SPEED - 1
                        zf["reverse"] = int(not zf["reverse"])
                    else:
                        zf["vitesse"] = (newvit
                                         + zf["vitesse"] * 4) // 5
                    self.lockvar += 50
            if self.irand(1000) == 0:           # mega-slow
                zfd_update = True
                zf["vitesse"] = STOP_SPEED - 1
                zf["pertedec"] = 8
                zf["sqrtperte"] = 16
                self.goomvar = 1
                self.lockvar += 70

        if self.speedvar < 1 and zf["vitesse"] < STOP_SPEED - 4 \
                and self.cycle % 16 == 0:
            zfd_update = True
            zf["vitesse"] += 3
            zf["pertedec"] = 8
            zf["sqrtperte"] = 16
            self.goomvar = 0
        if self.cycle % 73 == 0 and zf["vitesse"] < STOP_SPEED - 5:
            zfd_update = True
            zf["vitesse"] += 1
        if self.cycle % 101 == 0 and zf["pertedec"] == 7:
            zfd_update = True
            zf["pertedec"] = 8
            zf["sqrtperte"] = 16

        # zoomFilterFastRGB (filters.c:352-510)
        if zfd_update:
            if zf["reverse"]:
                zf["vitesse"] = 256 - zf["vitesse"]
            self._gen_map()
        self._zoom_apply()

        if self.agoom > 15:
            line_id = (self.lineMode // 10
                       if (zf["middleX"] == w // 2
                           and zf["middleY"] == h // 2
                           and zf["mode"] != WATER_MODE) else 0)
            self._lines(data, line_id, self.agoom - 15)

        out = self.p2[:w * h].copy()
        self.p1, self.p2 = self.p2, self.p1
        self.cycle += 1
        if self.cycle % 100 == 0:
            if self.totalgoom > 15:
                self.goomlimit += 1
            elif self.totalgoom == 0 and self.goomlimit > 1:
                self.goomlimit -= 1
            self.totalgoom = 0
        return out


@register_element
class Goom2k1(AudioVisualizerElement):
    FACTORY = "goom2k1"
    DESCRIPTION = "Takes frames of data and outputs video frames " \
                  "based on the amplitude of the sound (goom2k1)"
    PROPERTIES = dict(AudioVisualizerElement.PROPERTIES,
                      shader=(str, "none", "goom paints every pixel"),
                      seed=(int, 0, "RNG table seed (reference uses "
                                    "nondeterministic libc rand)"))

    def setup(self):
        self._goom = GoomState(self._w, self._h, self.props["seed"])

    def render(self, canvas: np.ndarray, data: np.ndarray) -> None:
        # gstgoom.c:161-177 — take the first 512 samples of the
        # window, duplicating mono into both channels
        stereo = np.zeros((2, 512), np.int64)
        n = min(512, data.shape[0])
        stereo[0, :n] = data[:n, 0]
        stereo[1, :n] = data[:n, 1] if data.shape[1] > 1 \
            else data[:n, 0]
        canvas[:self._w * self._h] = self._goom.update(stereo)
