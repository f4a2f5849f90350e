"""coloreffects / chromahold -- colour lookup-table filters.

The JAX package's ``elements/coloreffects.py`` (reference:
gst-plugins-bad/gst/coloreffects/) on torch:

* coloreffects (gstcoloreffects.c): the five 768-byte preset tables of the
  plugin (gstcoloreffects.c:117-286; heat, sepia and xray map the LUMA to
  an RGB ramp, xpro and yellowblue map each RGB component through its own
  curve) with the 8-bit SDTV fixed-point matrices (:288-301, APPLY_MATRIX
  >> 8), as int64 gathers and integer products on the planes' device; the
  table goes to the device once, when the function is made;
* chromahold (gstchromahold.c): keeps the target chroma and sets the rest
  to neutral.  The reference's keep test is float32 ``atan2`` / degrees /
  ``sqrt`` over the two uint8 chroma planes, so it has one answer per
  (u, v) pair: the port evaluates it on the host over all 65 536 pairs,
  in float32, once per property set (``chromahold_table``) and gathers
  the table on the device.
"""

from __future__ import annotations

import base64
import math

import numpy as np
import torch

from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_CAPS = ("video/x-raw, format={ AYUV }, width=[1,32767], "
         "height=[1,32767], framerate=[0/1,2147483647/1]")

_SEPIA = (
    "AAAAAAAAAAAAAAEAAQEAAQEAAQEBAgEBAgIBAwIBAwIBAwIBBAMCBAMCBAMCBgQCBgQC"
    "BgQCBwUCBwUDCQYDCQYDCgcDCwgDDQgEDgkEDwkEEQoEEgsEEgsFEwwFFA0FFg4GGRAG"
    "GREGGhIHHBIHHRMHIBQIIBYIIRYJIxgJJhkKJhoKJxwLKRwLKh8LLB8LLSAMLiINMCIN"
    "MiMPMyYPNCYPNScQOCgROSkROioTPCwTPS0TQS4UQTAVQjAVQzIWRDMYSDQYSDcZSzca"
    "SzgaTDkbTTocUDwcUT0dUz4fVD8fVUEgVkIhWEMhWkQjXEYjXkcjXkokYEomYksnYk0n"
    "ZU0oZk8pZ1ApaVEqa1MsbVQtbVUtblYub1gvclkwc1oydV0ydl0zd14zeGA0emE1e2M3"
    "fGM4fmU4f2Y5gGk6g2k8hGo8hms9h20+iG4/iW8/i3FBjHJDjXNDj3VEkHZEkXdGk3hH"
    "lHpIlXtKl3xLmH5LmX9MmoBNnIJPnYNQnoRRoIZRoYdToohUo4lVpYtWpoxYp41ZqI9Z"
    "qpBaq5FcrJNdrJRerZVgr5dhsJhisZljsppltJxltZ1mtp5nt6Bpt6FpuqJru6NtvKVu"
    "vKZvvqdxv6hywKpzwat1wqx2xK13xa94xq96xrF7x7J8yLR+yLV/y7aAzLeCzbeDzrqE"
    "z7uGz7yH0L6I0r+J07+L1MGM1cKN1sSP1sWQ18aR18eT2ciU28mV3MmX3MuX3c2Z3c6Z"
    "38+c4NCd4dCd4dOg4tSh49Si49aj5del5dil5tmo5tuq59yr6d2s6d2t6d+v6uCw6+Gw"
    "7OKy7eO07eS17eW27ua27ue67+i78Om88Om+8eq/8evA8uvB8uzC8u3E8u7F9O/F9O/I"
    "9PDJ9fHL9fHM9vLN9vLO9vPO9/TQ9/TQ9/XU9/XU+PbW+PbX+fbY+ffZ+ffb+fjb+vje"
    "+vje+vng+/nh+/ri+/rj/Prk/Pvk/Pvn/Pzo/fzp/fzp/fzq/f3q/v3r/v7t/v7u/v7v"
    "///v"
)
_HEAT = (
    "AAAAAAAAAAEAAAEAAAEBAAIBAAIBAQIBAQICAQICAQMCAQMDAQMDAQQDAQQEAQUEAQUF"
    "AgUGAgYGAgYHAgYHAgcHAgcJAggJAggKAwkLAwkLAwkMAwoNAwoPAwsPAwwQAwwSBA0T"
    "BA4UBA4WBA4XBA8ZBBAcBBEcBREgBRIgBRIkBRMkBRUmBhUoBhYtBhYtBhcwBhkyBxk1"
    "Bxo7Bxw7Bxw/CB1DCB5HCB9MCCBWCSFWCSJbCSRhCSZsCiZsCidyCih+Cyp+CyyEDCyL"
    "DC6RDC+XDDGeDTKkDTSqDTWwDje3Dji9DzrCDzvIDz3TED/TEUDYEUTdEUTiEkXmEknr"
    "E0nuE0vyFE31FE74FVD6FlL8FlT+Flb/F1j/F1r/GFz+GWD+GWD9GmL7GmT5G2b2HGrz"
    "HGrwHWzsHm7oHnLkH3LfIHTbIHfWIXnRInzMI37HJIHBJIS3JYe3JoqxJ4ysKI+nKJKh"
    "KZacKpmXK5ySLJ+OLaKJLqWFL6mBMKx9Ma96MrJ3M7Z0NLlwNbxtNr9qN8JmOMVjOchg"
    "OsxcO89ZPNFWPtRTP9dQQNpMQd1JQt9GQ+JDReRARuc9R+k7Ses4Se04Te8zUPEwU/Mu"
    "VvUrWfYpXPgnYPklZPojZ/sibPwgcPwfdPwddP0cff4bgv4agv0Zi/0YkP0Xlf0XmvsW"
    "n/oVpPkUqfgTrvcTsvcSt/QRvPIQwPEQxe8Pye0OyesO0ukN1uYN2uYM3uQM4d8L4d0L"
    "6NoK69gJ7tgJ8NII8tAI9NAI9MoH9scH9sQH98IG978G+LwF97kF97kF97ME9bAE9K0E"
    "86sD8qgD8aUD8KID76AD750C7ZoC7ZcC7JUC65EB644B644B64sB64QB64EB7H0B7HkA"
    "7HYA7XIA7W4A7WoA7mYA7mIA718A71sA71cA71MA8E8A8E8A8UsA8UMA8kAA8zwA8zgA"
    "9DgA9DEA9S4A9isA9icA9ycA+CEA+B4A+BsA+RgA+RYA+xYA+xMA/A0A/AsA/QgA/QUA"
    "/gMA"
)
_XRAY = (
    "/////////v7+/f3+/P39+/z9+vz8+fz8+Pv79vv69vr69fr58/n58/n48vj48Pj38Pf2"
    "7/f17vb17fb06/Xz6/Xz6vTy6fPy5/Px5vLx5fLx5PLw4/Hv4/Hu4vDu4fDu4O/t3u7s"
    "3u7s3e3r3O3r2+3q2ezp2evp2Ovo1+vo1ern1enn1Ojm0+jl0ufk0efk0Ofkz+bjzubi"
    "zeXhzOThy+TgyuTgyePfyOLfx+LdxuHdxeHdw+Dcw9/bwt/bwd/awN7Zvt3ZvtzYvNzY"
    "vNzXu9vXutvWudrVuNrVt9nUttjTtdjTtNfSs9fRstbQsdXQr9XPr9TPrtTOrNPNrNLN"
    "q9LMqtHLqdHLqNDKps/Jpc/Jpc7IpM7Ho83HoszGoczFoMrFn8rEnsrDncnDnMnCm8fB"
    "msfAmcfAmMa/l8W+lsW+lcS9lMO8k8O7ksK7kcG6kMG5j8C4jr+4jb+3jL62i721ir21"
    "iby0iLuzh7uyhrqyhbmxhLiwg7ivgrevgbaugLatf7WsfrSrfbOrfLOqe7KperGoebCn"
    "eLCnd6+mdq6lda2kdK2jc6yjcquicaqhcKqgb6mfbqiebaedbKadbKadaqWbaaSaaKOZ"
    "Z6KYZqKXZaGWZKCWY5+VYp6UYZ2TYJySX5yRX5uQXZqPXJmOXJiNWpeMWZaMWJaLV5WK"
    "VpSJVZOIVJKHU5GGUpGFUY+EUI6DT42CTo2BTYyATYt/S4p+Sol9SYl8SIh8R4Z6R4V6"
    "RYR4RIN2Q4N2QoF0QYBzQIBxQH5wPn1vPnxvPHtsPHlrO3hpOXdoOHdnOHRlNnNkNXFk"
    "NHBhM25fMm1dMWtcMGpcMGhZLmZXLWRVLGNUK2FSKl9QKV9PKF1NJ1lLJ1hJJVZJJFRG"
    "JFJEIk9CIU1AIEs/H0k9H0c9HUU5HEM5HEE1Gz41GTwyGTwwFzouFzUsFjMqFDEqEy4m"
    "Ei4mEioiEScgDyUeDiIcDSIaDB4aCxsWCxkUCRYSCRQQBxQOBhEOBQwMBAoIAwcGAwUE"
    "AQIC"
)
_XPRO = (
    "AAAfAAAfAAEgAAIhAAIiAAMiAQQlAQQlAQUlAQUnAQcnAQcoAQcoAQgqAQkrAQksAQos"
    "AQsvAQwvAQwxAg0xAg0xAg40Ag80Aw81AxI3AxI3AxM4AxQ5AxU7AxY7Axc8Axc9BBk9"
    "BBs/BBxABRxCBR1DBR5EBSBEBSBHBSFHBiJIBiRIByZKByZLBypNBypNCCtOCC1QCS1Q"
    "CS9SCTNSCTNUCjRVCjVVCzdXDDhZDDlZDDxZDj1bDkBeDkBeD0NeD0RgEEZgEEpiEkpi"
    "EktjE01lFE5mFVFnFlJnF1RpF1dqGFhsGVlsG1xtHF5wHWBwIGJwIGZxIWZyJGd0JGx0"
    "JWx1J212KHB4KnF5LXR5L3V6L3h8MHl9M3x9NH1+NX+BOIOBOYOBO4SCPYeDP4iEQIyE"
    "Q4yGRI6HR4+ISJOJS5OJTZWKUJaMUZmNVJqNVZyOWJ2PWaCQXKGQXqORYKSTYqaUZaiU"
    "ZqqVaauWbK2Xba6ZcLGZcbKadLSbdrWceLeceridfLmefryggb2ggr+hhMCih8KjiMOj"
    "isWkjMaljsemkMmokcuolM2pls6ql8+rmtGrnNKsndOtoNWuotauotiupdmxqNmyqdqy"
    "q9yzrd20rt61seC2s+G2tOK3tuO4uOS5ueS5uea7vue8v+i9v+m9wuq+xOu/xuvAx+3A"
    "ye7BzO7Cze/Dz/DE0PDE0vHF0/LG1fLH1/PH2PPI2PTJ2/TL3PXL3vXM4PXM4vbO4vbO"
    "5vfP5/fQ6ffQ6/jS7PjS7vjT7vjU8PnV8PnV8/nW8/nX8/rY9frY9vrZ9vrZ+Pra+fva"
    "+fvb+vvc+/vd+/ve/Pve/Pzf/Pzg/fzh/fzh/vzi/vzj/vzk/vzk//zl//zm//3m//3m"
    "//3n//3o//3p//3q//3q//3q//3r//3r//7s//7s//7u//7u//7u//7v//7w//7w//7w"
    "//7w//7y//7y//7z//7z//7z//7z//70//70//71///1///2///2///2///3///3///3"
    "///4"
)
_YELLOWBLUE = (
    "AAD/AQH+AgL9AwP8BAT7BQX6Bgb5Bwf4CAj3CQn3Cgr1Cwv0DAzzDQzyDg7xDw/wEBDv"
    "EBHuEhLtExPsFBTsFBXqFhbpFxfoFxjnGRnmGhrlGxrkHBzjHBziHh7hHx7gICDfISHe"
    "ISHdIyPcJCPcJSXaJiXZJybYKCjXKCnWKinVKyvULCzTLS3SLi7RLy/QLzDPMTHPMjLN"
    "MjLMNDTMNDXLNTXKNzbJODjHOTnGOTrFOzvFPDzEPT3CPj7BPj7AQEDAQEG+QUK9QkO8"
    "Q0S7REW6RUW6Rka4SEi4SEm2SUq1S0u0S0yzTU2yTk6yTk6xT0+vUVCuUlGuUlKsVFSr"
    "VVWrVlWpVleoWFinWFmmWVqlW1ulW1ujXV2jXl6iXl+gX2CfYGGeYWGdYmKdZGObZGWb"
    "ZmaaZ2aZaGeYaGmXammWa2qVbGuTbG2Tbm2Sbm6Rb3CPcXGOcnKNc3OMc3SLdXWLdXWJ"
    "d3aId3eHeHiHeXqFenuFe3uEfHyDfX2Cf36Bf4B/gIF/goJ+g4J8hIN8hIR7hYZ6h4Z4"
    "h4d3iYh3iYl2iop1i4xzjIxyjY1yjo9xj49wkZBvkZJuk5JslJNrlJRrlZVqlpZpl5do"
    "mJlmmZlmm5plm5tjnJxjnZ1inp5hn59goaBfoqFeoqJdo6RcpKRbpaVZpqZZqKdYqKhX"
    "qalWqqpUq6tUrK1Trq1Sr65Rr7BQsLFPsbFOsrJNs7NMtLVLtbVKtrZJt7hIuLhHublG"
    "urpFu7tDvLxCvb1Cvr5Bv79AwMA/wcE+wsI9w8M8xMQ7xcU6xsY5x8c4yMg3yck2yso1"
    "y8s0zMwzzc0yzs4xz88w0NAv0dEu0tIt09Ms09Qr1dUq1tYp19co2Ngn2dkm2tkl29ok"
    "3Nwj3N0i3t4h398g4OAf4eEe4uId4+Mc5OQb5eUa5eYZ5+cY6OgX6ekW6uoV6+sU7OwT"
    "7O0S7u4R7+8Q8PAP8fEO8vIN8/IM9PQL9fUK9fYJ9/cJ+PgH+fkG+vkF+/sE/PwE/f0D"
    "/f4B"
)


def _tab(b64: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), np.uint8).reshape(
        256, 3).astype(np.int32)


TABLES = {
    "heat": (_tab(_HEAT), True),
    "sepia": (_tab(_SEPIA), True),
    "xray": (_tab(_XRAY), True),
    "xpro": (_tab(_XPRO), False),
    "yellowblue": (_tab(_YELLOWBLUE), False),
}

# gstcoloreffects.c:288-298 — 8-bit SDTV matrices, >> 8 apply
_YUV2RGB = np.array([[298, 0, 409, -57068],
                     [298, -100, -208, 34707],
                     [298, 516, 0, -70870]], np.int64)
_RGB2YUV = np.array([[66, 129, 25, 4096],
                     [-38, -74, 112, 32768],
                     [112, -94, -18, 32768]], np.int64)


def effect_fn(preset: str, device=None):
    """Device fn over (Y, U, V, A) planes, or None for "none"."""
    if preset == "none":
        return None
    table, map_luma = TABLES[preset]
    t = torch.as_tensor(table.astype(np.int64), device=device)
    yuv2rgb, rgb2yuv = _YUV2RGB.tolist(), _RGB2YUV.tolist()

    def matrix(m, a, b, c):
        return [(r[0] * a + r[1] * b + r[2] * c + r[3]) >> 8 for r in m]

    def fn(planes):
        y, u, v = (p.to(torch.int64) for p in planes[:3])
        if map_luma:
            rgb = [t[:, k][y] for k in range(3)]
        else:
            rgb = [t[:, k][torch.clamp(c, 0, 255)]
                   for k, c in enumerate(matrix(yuv2rgb, y, u, v))]
        dt = planes[0].dtype
        return [torch.clamp(c, 0, 255).to(dt)
                for c in matrix(rgb2yuv, *rgb)] + [planes[3]]

    return fn


def chromahold_table(target_r: int, target_g: int, target_b: int,
                     tol: int) -> np.ndarray:
    """(256, 256) bool: keep the chroma of (u, v)?  The reference's float32
    test (hue difference within `tol` degrees, saturation above 2) on every
    pair, each operation rounded to float32 as XLA evaluates it: atan2 is
    taken in float64 and rounded, degrees is a product by float32(180/pi),
    the difference wraps with a floor modulo."""
    tu = int((_RGB2YUV[1, 0] * target_r + _RGB2YUV[1, 1] * target_g
              + _RGB2YUV[1, 2] * target_b + _RGB2YUV[1, 3]) >> 8)
    tv = int((_RGB2YUV[2, 0] * target_r + _RGB2YUV[2, 1] * target_g
              + _RGB2YUV[2, 2] * target_b + _RGB2YUV[2, 3]) >> 8)
    target_hue = np.float32(math.degrees(math.atan2(tv - 128, tu - 128)))
    f32 = np.float32
    c = np.arange(256, dtype=np.float32) - f32(128)
    uf, vf = c[:, None], c[None, :]
    hue = np.arctan2(vf.astype(np.float64), uf.astype(np.float64)) \
        .astype(np.float32) * f32(180 / np.pi)
    diff = np.abs(np.remainder(hue - target_hue + f32(180), f32(360))
                  - f32(180))
    sat = np.sqrt(uf * uf + vf * vf)
    return (diff <= f32(tol)) & (sat > f32(2))


@register_element
class ColorEffects(TransformElement):
    FACTORY = "coloreffects"
    DESCRIPTION = "Color Look-up Table filter"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = {
        "preset": (str, "none",
                   "none|heat|sepia|xray|xpro|yellowblue"),
    }

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        return effect_fn(self.props["preset"], self.device)


@register_element
class ChromaHold(TransformElement):
    """chromahold (gstchromahold.c): desaturate everything whose hue
    differs from the target color beyond tolerance."""
    FACTORY = "chromahold"
    DESCRIPTION = "Removes all color information except for one color"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = {
        "target-r": (int, 255, "target red"),
        "target-g": (int, 0, "target green"),
        "target-b": (int, 0, "target blue"),
        "tolerance": (int, 30, "hue tolerance"),
    }

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        keep = torch.as_tensor(chromahold_table(
            self.props["target-r"], self.props["target-g"],
            self.props["target-b"], self.props["tolerance"]).reshape(-1),
            device=self.device)

        def fn(planes):
            y, u, v, a = planes[:4]
            k = keep[u.to(torch.int64) * 256 + v.to(torch.int64)]
            return [y, torch.where(k, u, 128).to(u.dtype),
                    torch.where(k, v, 128).to(v.dtype), a]

        return fn
