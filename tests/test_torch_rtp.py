"""The port's RTP core against the JAX package, bit for bit: ``net/rtp.py``
(the RTP header, RFC 4175 raw video, L16, rtpjitterbuffer),
``net/rtp_raw_audio.py`` (L8, L24, asteriskh263), ``net/rtp_hdrext.py``
(the RFC 8285 extensions and their seven elements) and
``net/transport.py`` (udpsrc / udpsink and the four TCP elements).

Two kinds of case.  The JAX package's own tests of these modules
(``tests/test_rtp.py``, ``test_rtp_raw_audio.py``, ``test_rtp_hdrext.py``,
``test_transport.py``) run again with every name they take from the JAX
package bound to the port's object of the same name (``on_port``: launch
strings and elements on the CPU; a test class's helper methods too,
through a port copy of the class), and a case fails if it builds an
element of the JAX package.  And the same seeded inputs go through
both packages: packets byte for byte (sequence numbers, timestamps and
SSRCs included), depayloaded frames and PCM, caps and timestamps equal,
tolerance 0.  Socket cases bind port 0 and wait on a condition with a
deadline.  ``on_port`` and ``packets`` serve the other files of this slice.
"""

import builtins
import contextlib
import functools
import importlib
import inspect
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import Element as JElement
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.net import rtp as jrtp
from gstreamer_tpu.net import rtp_hdrext as jext

import gstreamer_tpu_torch
from gstreamer_tpu_torch.check import harness as tharness
from gstreamer_tpu_torch.codecs import jpeg as tjpeg
from gstreamer_tpu_torch.core import pipeline as tpipeline
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch
from gstreamer_tpu_torch.net import rtp as trtp
from gstreamer_tpu_torch.net import rtp_hdrext as text
from gstreamer_tpu_torch.net import rtsp_server as trtsp_server
from gstreamer_tpu_torch.video import hdr as thdr

import test_rtp
import test_rtp_hdrext
import test_rtp_raw_audio
import test_transport
from test_torch_analytics import same_spec
from test_torch_captions import pair, plain
from test_torch_flow import NET_FACTORIES

CPU = torch.device("cpu")
DEADLINE = 10.0          # seconds a socket case waits for its condition


# -- running the JAX package's tests on the port ------------------------------
def _cpu_make(factory, name=None, **props):
    e = tmake(factory, name=name, **props)
    e.device = CPU
    return e


class _CpuMediaFactory(trtsp_server.RTSPMediaFactory):
    """The port's media factory with its pipelines on the CPU."""

    def __init__(self, launch, rate_control=True, transport_mode="play",
                 device="cpu"):
        super().__init__(launch, rate_control, transport_mode, device)


class _CpuPipeline(tpipeline.Pipeline):
    """The port's Pipeline on the CPU unless a device is named."""

    def __init__(self, name=None, device="cpu"):
        super().__init__(name, device)


class _CpuHarness(tharness.Harness):
    """The port's Harness (its pipeline and sub-harnesses) on the CPU."""

    def __init__(self, element_or_launch, device="cpu", **props):
        super().__init__(element_or_launch, device, **props)


_CPU_VERSIONS = {
    id(tparse_launch): functools.partial(tparse_launch, device="cpu"),
    id(gstreamer_tpu_torch.parse_launch):
        functools.partial(tparse_launch, device="cpu"),
    id(tmake): _cpu_make,
    id(trtsp_server.RTSPMediaFactory): _CpuMediaFactory,
    id(tjpeg.jpeg_decode): functools.partial(tjpeg.jpeg_decode, device="cpu"),
    id(tpipeline.Pipeline): _CpuPipeline,
    id(tharness.Harness): _CpuHarness,
    id(thdr.convert_sample): functools.partial(thdr.convert_sample,
                                               device="cpu"),
}


def _port_module(name):
    return importlib.import_module("gstreamer_tpu_torch"
                                   + name[len("gstreamer_tpu"):])


def _is_jax(name):
    return name == "gstreamer_tpu" or name.startswith("gstreamer_tpu.")


class _Missing:
    """A JAX-package name the port has no counterpart for: a test that
    reaches it fails, naming it (only a skip mark may name one)."""

    def __init__(self, what):
        self._what = what

    def __getattr__(self, name):
        raise AttributeError(f"the port has no {self._what}")

    def __call__(self, *a, **kw):
        raise AttributeError(f"the port has no {self._what}")


def _port_of(v):
    """The port's object for a value a test took from the JAX package: a
    module by its path, a class or function by its module and name (the
    CPU version where the port's runs on the card by default)."""
    if isinstance(v, types.ModuleType):
        if _is_jax(v.__name__):
            try:
                return _PortModule(_port_module(v.__name__))
            except ModuleNotFoundError:
                return _Missing(f"module for {v.__name__}")
        if v.__name__.split(".")[0] == "gstreamer_tpu_torch":
            return _PortModule(v)
        return v
    mod = getattr(v, "__module__", None)
    if isinstance(mod, str) and _is_jax(mod) and hasattr(v, "__name__"):
        try:
            v = getattr(_port_module(mod), v.__name__)
        except (ModuleNotFoundError, AttributeError):
            return _Missing(f"{mod}.{v.__name__}")
    return _CPU_VERSIONS.get(id(v), v)


class _PortModule:
    """A port module whose attributes come through ``_port_of``."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return _port_of(getattr(self._mod, name))


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``import`` inside a test body: the JAX package's modules come from
    the port (``import gstreamer_tpu.x`` binds the port's top package,
    with its ``x`` imported)."""
    if level == 0 and _is_jax(name):
        mod = _port_module(name)
        if fromlist:
            for sub in fromlist:      # `from package import module`
                if not hasattr(mod, sub):
                    with contextlib.suppress(ModuleNotFoundError):
                        importlib.import_module(f"{mod.__name__}.{sub}")
            return _PortModule(mod)
        return _PortModule(importlib.import_module("gstreamer_tpu_torch"))
    return builtins.__import__(name, globals, locals, fromlist, level)


_GLOBALS = {}


def _port_globals(src):
    key = src["__name__"]
    if key not in _GLOBALS:
        g = {k: _port_of(v) for k, v in src.items()}
        g["__builtins__"] = dict(vars(builtins), __import__=_port_import)
        for k, v in src.items():     # the module's own helpers, rebound
            if isinstance(v, types.FunctionType) and v.__module__ == key:
                g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                          v.__defaults__, v.__closure__)
        _GLOBALS[key] = g
    return _GLOBALS[key]


def on_port(fn):
    """`fn`, a test (or fixture body) of the JAX package, with every name
    it takes from the JAX package bound to the port's object of that name,
    at module level and in ``import`` statements inside it."""
    fn = getattr(fn, "_get_wrapped_function", lambda: fn)()
    g = _port_globals(fn.__globals__)
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def reference_tests(module, exclude=()):
    """(id, function, parametrize args) of every test of a JAX test module,
    class methods included, that takes no fixture but `tmp_path` and its
    own parameters.  A test under a ``skipif`` mark (a library the port
    does not have) is left out."""
    out = []

    def add(prefix, fn):
        marks = getattr(fn, "pytestmark", [])
        if any(m.name == "skipif" for m in marks) or prefix in exclude:
            return
        params = [m for m in marks if m.name == "parametrize"]
        if params:
            names, values = params[0].args[:2]
            for k, v in enumerate(values):
                out.append((f"{prefix}[{k}]", fn, names, v))
        else:
            out.append((prefix, fn, None, None))

    for n, v in vars(module).items():
        if n.startswith("test_") and inspect.isfunction(v):
            add(f"{module.__name__}::{n}", v)
        elif n.startswith("Test") and inspect.isclass(v):
            for m, f in vars(v).items():
                if m.startswith("test_") and inspect.isfunction(f):
                    add(f"{module.__name__}::{n}::{m}", f)
    return out


_PORT_CLASSES = {}


def _port_class(cls):
    """A copy of a JAX test class with its methods (helpers too) run
    through ``on_port`` and its other attributes through ``_port_of``."""
    if cls not in _PORT_CLASSES:
        body = {}
        for k, v in vars(cls).items():
            if k in ("__dict__", "__weakref__"):
                continue
            if inspect.isfunction(v):
                v = on_port(v)
            elif isinstance(v, (staticmethod, classmethod)):
                v = type(v)(on_port(v.__func__))
            elif not k.startswith("__"):
                v = _port_of(v)
            body[k] = v
        _PORT_CLASSES[cls] = type(cls.__name__, (), body)
    return _PORT_CLASSES[cls]


@contextlib.contextmanager
def no_jax_elements():
    """Fail the case if it builds an element of the JAX package: a name
    that was not bound to the port's would otherwise pass silently."""
    built = []
    init = JElement.__init__

    def spy(self, *a, **kw):
        built.append(type(self).__name__)
        init(self, *a, **kw)

    JElement.__init__ = spy
    try:
        yield
    finally:
        JElement.__init__ = init
    assert not built, f"the case built JAX elements: {sorted(set(built))}"


def run_on_port(fn, names, values, tmp_path, **fixtures):
    """Call a collected reference test on the port, its class's `self` an
    instance of the class's port copy (``_port_class``), `tmp_path` and
    `fixtures` passed by name.  Fails if the case builds a JAX element."""
    f = on_port(fn)
    params = list(inspect.signature(fn).parameters)
    args = {}
    if names is not None:
        keys = [k.strip() for k in names.split(",")] if isinstance(
            names, str) else list(names)
        vals = values if len(keys) > 1 else (values,)
        args.update(zip(keys, vals))
    fixtures = dict(fixtures, tmp_path=tmp_path)
    for p in params:
        if p in fixtures and p not in args:
            args[p] = fixtures[p]
    if params and params[0] == "self":
        cls = fn.__qualname__.split(".")[0]
        args["self"] = _port_class(getattr(
            importlib.import_module(fn.__module__), cls))()
    with no_jax_elements():
        return f(**args)


REFERENCE = (reference_tests(test_rtp) + reference_tests(test_rtp_raw_audio)
             + reference_tests(test_rtp_hdrext) + reference_tests(
                 test_transport))


@pytest.mark.parametrize("alias, base", [("av1dec", "avdec_av1"),
                                         ("dav1ddec", "avdec_av1"),
                                         ("dvdec", "avdec_dvvideo")])
def test_av1dec_alias_waits_for_the_aliases_module(alias, base):
    """The decoder aliases of ``elements/aliases.py`` (av1dec, dav1ddec,
    dvdec), which waited for that module: registered in both packages
    exactly where libavcodec has the codec their libav decoder wraps, each
    a subclass of that decoder."""
    from gstreamer_tpu.core import element as jel
    from gstreamer_tpu_torch.core import element as tel
    from gstreamer_tpu_torch.native import av
    from test_torch_libav import load_jax_av
    load_jax_av()
    codec = {"avdec_av1": "libdav1d", "avdec_dvvideo": "dvvideo"}[base]
    have = av.available() and av.have_codec(codec)
    assert tel.factory_exists(base) == have
    assert tel.factory_exists(alias) == have
    assert jel.factory_exists(alias) == jel.factory_exists(base) == have
    if have:
        for el in (jel, tel):
            assert issubclass(el.get_factory_class(alias),
                              el.get_factory_class(base))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    """The JAX package's RTP, raw-audio, extension and transport tests, on
    the port's modules (the av1dec alias case among them)."""
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


@pytest.mark.parametrize("factory", NET_FACTORIES)
def test_factory_spec_matches_reference(factory):
    """Properties, pad templates, description and HOST_ELEMENT of the 60
    factories as the JAX package's."""
    same_spec(factory)


# -- packets -----------------------------------------------------------------
def packets(data):
    """A buffer's packets as bytes (either package, any leaf type)."""
    if not isinstance(data, list):
        data = [data]
    return [bytes(p) if isinstance(p, (bytes, bytearray))
            else plain(p)[3] for p in data]


@pytest.mark.parametrize("kw", [
    dict(payload_type=96, seq=7, timestamp=1234, ssrc=5),
    dict(payload_type=26, seq=0xFFFF, timestamp=0xFFFFFFFF, ssrc=0xCAFE,
         marker=True),
    dict(payload_type=111, seq=1, timestamp=2, ssrc=3,
         extension=jext.build_one_byte_extensions([(1, b"\xaa"),
                                                   (14, b"x" * 16)]))])
def test_header_bytes_and_parse(kw):
    assert trtp.rtp_header(**kw) == jrtp.rtp_header(**kw)
    pkt = jrtp.rtp_header(**kw) + b"PAYLOAD"
    assert trtp.parse_rtp_header(pkt) == jrtp.parse_rtp_header(pkt)


def test_extension_elements_write_the_same_bytes():
    specs = [("rtphdrextclientaudiolevel", dict(id=1, level=42, voice=True)),
             ("rtphdrextmid", dict(id=2, value="a1")),
             ("rtphdrextstreamid", dict(id=4, value="hi")),
             ("rtphdrextrepairedstreamid", dict(id=9, value="r0")),
             ("rtphdrextntp64", dict(id=5, ntp=0x0102030405060708)),
             ("rtphdrexttwcc", dict(id=6)),
             ("rtphdrextcolorspace", dict(id=7, primaries=9, transfer=16,
                                          matrix=9, full_range=True))]
    items_j, items_t = [], []
    for factory, props in specs:
        j, t = jmake(factory, **props), tmake(factory, **props)
        for _ in range(3):
            wj, wt = j.write(), t.write()
            assert wt == wj
            assert plain(t.read(wt)) == plain(j.read(wj))
        items_j.append((j.ext_id, wj))
        items_t.append((t.ext_id, wt))
    block = text.build_one_byte_extensions(items_t)
    assert block == jext.build_one_byte_extensions(items_j)
    assert text.parse_one_byte_extensions(0xBEDE, block[4:]) == \
        jext.parse_one_byte_extensions(0xBEDE, block[4:])


def rgb_pushes(fmt, w, h, batch, ticks, seed):
    """Seeded frames of a packed RFC 4175 format as the JAX package's
    planes (``from_bytes`` of random bytes)."""
    from gstreamer_tpu.video.format import format_info, frame_size, \
        from_bytes
    finfo = format_info(fmt)
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        raw = rng.integers(0, 256, (batch, frame_size(finfo, w, h)),
                           dtype=np.uint8)
        out.append(dict(data=tuple(np.asarray(p) for p in from_bytes(
            finfo, raw, w, h)), pts=t * batch * 33333333,
            duration=33333333, batch=batch))
    return out


@pytest.mark.parametrize("fmt,w,h,mtu", [("RGB", 64, 48, 900),
                                         ("BGRA", 40, 30, 400),
                                         ("RGBA", 33, 17, 300),
                                         ("BGR", 48, 16, 1400)])
def test_vraw_pay_depay(fmt, w, h, mtu):
    """rtpvrawpay's packets, then rtpvrawdepay's frames, in both packages;
    the frames equal those sent."""
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"
    pushes = {"in": rgb_pushes(fmt, w, h, 2, 2, seed=hash(fmt) % 100)}
    _, ref, _, out = pair(
        f"appsrc name=in caps={caps} ! rtpvrawpay mtu={mtu} ! "
        "appsink name=out", pushes, batch=2)
    assert [packets(s.buffer.data) for s in out["out"]] == \
        [packets(s.buffer.data) for s in ref["out"]]
    pkts = {"in": [dict(data=list(s.buffer.data), pts=s.buffer.pts)
                   for s in ref["out"]]}
    _, ref2, _, out2 = pair(
        f"appsrc name=in caps=application/x-rtp ! rtpvrawdepay caps={caps} "
        "! appsink name=out", pkts)
    frames = [np.asarray(p) for s in ref2["out"]
              for p in s.buffer.data]
    sent = [p for b in pushes["in"] for p in b["data"]]
    assert len(frames) == len(sent)
    for a, b in zip(frames, sent):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,h,mtu", [(64, 36, 1400), (30, 8, 100)])
def test_vraw_uyvy_is_a_reference_fault(w, h, mtu):
    """A reference fault (ROADMAP.md section 3): the JAX rtpvrawpay takes
    UYVY's four components as four bytes a pixel and raises on reshaping
    the frame.  The port pays UYVY in RFC 4175 pixel groups (four bytes,
    two pixels; line offsets in pixels) and the frames come back whole."""
    caps = f"video/x-raw,format=UYVY,width={w},height={h},framerate=30/1"
    pushes = rgb_pushes("UYVY", w, h, 2, 1, seed=w)[0]
    jp = jparse_launch(f"appsrc name=in caps={caps} ! rtpvrawpay mtu={mtu} "
                       "! appsink name=out")
    jp.get_by_name("in").push_buffer(JBuffer(**pushes))
    jp.get_by_name("in").end_of_stream()
    with pytest.raises(ValueError, match="reshape"):
        jp.run()
    tp = tparse_launch(f"appsrc name=in caps={caps} ! rtpvrawpay mtu={mtu} "
                       f"! rtpvrawdepay caps={caps} ! appsink name=out",
                       device="cpu")
    tp.get_by_name("in").push_buffer(Buffer(**pushes))
    tp.get_by_name("in").end_of_stream()
    tp.run()
    out = tp.get_by_name("out").pull_sample().buffer
    assert out.batch == 2
    for a, b in zip(out.data, pushes["data"]):
        np.testing.assert_array_equal(a.numpy(), b)
    tp2 = tparse_launch(f"appsrc name=in caps={caps} ! rtpvrawpay name=p "
                        f"mtu={mtu} ! appsink name=out", device="cpu")
    tp2.get_by_name("in").push_buffer(Buffer(**pushes))
    tp2.get_by_name("in").end_of_stream()
    tp2.run()
    for pkt in tp2.get_by_name("out").pull_sample().buffer.data:
        length, line, off = struct.unpack("!HHH", pkt[14:20])
        assert length % 4 == 0 and off % 2 == 0 and len(pkt) <= mtu
        assert (off // 2 * 4 + length) <= w * 2


@pytest.mark.parametrize("pay,depay,fmt,dtype,ch,mtu", [
    ("rtpL16pay", "rtpL16depay", "S16LE", np.int16, 2, 400),
    ("rtpL16pay", "rtpL16depay", "S16LE", np.int16, 1, 1400),
    ("rtpL8pay", "rtpL8depay", "U8", np.uint8, 2, 300),
    ("rtpL24pay", "rtpL24depay", "S24BE", np.int32, 2, 1400),
    ("rtpL24pay", "rtpL24depay", "S24BE", np.int32, 1, 100)])
def test_raw_audio_pay_depay(pay, depay, fmt, dtype, ch, mtu):
    """Packets and depayloaded samples of L16 / L8 / L24 in both
    packages (int32 samples into L24: the JAX tests' input)."""
    rng = np.random.default_rng(ch * mtu)
    lo, hi = {np.int16: (-32768, 32767), np.uint8: (0, 255),
              np.int32: (-(1 << 23), (1 << 23) - 1)}[dtype]
    bufs = [dict(data=rng.integers(lo, hi, (960, ch)).astype(dtype),
                 pts=t * 20_000_000, duration=20_000_000) for t in range(3)]
    caps = f"audio/x-raw,format={fmt},rate=48000,channels={ch}," \
           "layout=interleaved"
    _, ref, _, out = pair(f"appsrc name=in caps={caps} ! {pay} mtu={mtu} "
                          "! appsink name=out", {"in": bufs})
    assert [packets(s.buffer.data) for s in out["out"]] == \
        [packets(s.buffer.data) for s in ref["out"]]
    pkts = {"in": [dict(data=list(s.buffer.data), pts=s.buffer.pts,
                        duration=s.buffer.duration) for s in ref["out"]]}
    pair(f"appsrc name=in caps=application/x-rtp ! {depay} caps=\"{caps}\" "
         "! appsink name=out", pkts)


def test_l24_packed_bytes_take_the_negotiated_channels():
    """A reference fault (ROADMAP.md section 3): the JAX rtpL24pay counts
    channels from the array's shape, so packed 24-bit stereo given as one
    row of bytes a frame (what rtpL24depay gives) advances the timestamp
    a third as fast as it should.  The port frames the bytes by the
    negotiated channel count: one timestamp tick a frame."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (100, 6), dtype=np.uint8)   # 2 ch x 3 B
    caps = "audio/x-raw,format=S24BE,rate=48000,channels=2"
    desc = f"appsrc name=in caps={caps} ! rtpL24pay mtu=72 ! appsink name=out"

    def stamps(parse, buf_cls, **kw):
        p = parse(desc, **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=frames, pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()
        pk = p.get_by_name("out").pull_sample().buffer.data
        return [jrtp.parse_rtp_header(x) for x in pk]

    def frames_before(hs):     # frames sent before each packet's payload
        return [int(f) for f in np.cumsum(
            [0] + [len(h["payload"]) // 6 for h in hs[:-1]])]

    port = stamps(tparse_launch, Buffer, device="cpu")
    ref = stamps(jparse_launch, JBuffer)
    assert b"".join(h["payload"] for h in port) == frames.tobytes() == \
        b"".join(h["payload"] for h in ref)
    assert [len(h["payload"]) % 6 for h in port] == [0] * len(port)
    assert [h["timestamp"] for h in port] == frames_before(port)
    # the JAX package: 54-byte payloads (9 frames) stamped 3 frames apart
    assert [h["timestamp"] for h in ref] == \
        [f // 3 for f in frames_before(ref)]


def test_asteriskh263_framing_matches():
    pkts = [jrtp.rtp_header(96, k, 1000 + 3000 * k, 7, marker=k % 3 == 2)
            + bytes(range(k, k + 20)) for k in range(7)]
    j, t = jmake("asteriskh263"), _cpu_make("asteriskh263")
    assert packets(t.host_process(Buffer(data=list(pkts), pts=0)).data) == \
        packets(j.host_process(JBuffer(data=list(pkts), pts=0)).data)


def _jitter_input(seed):
    """Packets of one stream with reordering, duplicates, a late packet
    and a hole, in ticks of a few packets."""
    rng = np.random.default_rng(seed)
    seqs = list(range(65530, 65536)) + list(range(0, 30))
    order = []
    for k in range(0, len(seqs), 6):
        chunk = seqs[k:k + 6]
        rng.shuffle(chunk)
        order.extend(chunk)
    order.insert(10, order[3])           # a duplicate
    order.remove(order[20])              # a hole
    order.append(seqs[2])                # a late packet
    pk = [jrtp.rtp_header(96, s, (s * 3000) & 0xFFFFFFFF, 0xABC)
          + b"x" * 10 for s in order]
    return [dict(data=pk[k:k + 5], pts=k * 1000) for k in range(0, len(pk),
                                                                   5)]


@pytest.mark.parametrize("props", ["latency=200", "latency=20 do-lost=true",
                                   "latency=0"])
def test_jitterbuffer_matches(props):
    """rtpjitterbuffer: the same packets out, in the same ticks, and the
    same statistics."""
    jp, _, tp, _ = pair("appsrc name=in caps=application/x-rtp,"
                        f"clock-rate=90000 ! rtpjitterbuffer name=jb {props} "
                        "! appsink name=out", {"in": _jitter_input(1)})
    assert tp.get_by_name("jb").stats == jp.get_by_name("jb").stats


# -- sockets ------------------------------------------------------------------
def _until(cond, what):
    end = time.monotonic() + DEADLINE
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"no {what} within {DEADLINE} s")
        time.sleep(0.005)


def test_l16_over_udp_matches_in_process():
    """rtpL16pay ! udpsink into udpsrc ! rtpL16depay on the port, the
    sender and receiver alternated one tick at a time: the samples equal
    those sent, and equal the JAX package's in-process round trip."""
    rng = np.random.default_rng(5)
    x = rng.integers(-32768, 32767, (4800, 2), np.int16)
    caps = "audio/x-raw,format=S16LE,rate=48000,channels=2,layout=interleaved"
    rx = tparse_launch("udpsrc name=u port=0 timeout=1.0 ! "
                       f"rtpL16depay caps=\"{caps}\" ! appsink name=s",
                       device="cpu")
    rx.set_state("playing")
    port = rx.get_by_name("u").bound_port
    tx = tparse_launch(f"appsrc name=in caps={caps} ! rtpL16pay mtu=1400 ! "
                       f"udpsink port={port}", device="cpu")
    src = tx.get_by_name("in")
    for k in range(0, 4800, 960):
        src.push_buffer(Buffer(data=x[k:k + 960], pts=k))
    src.end_of_stream()
    tx.set_state("playing")
    got = []
    n_pkts = -(-960 * 4 // 1400)        # datagrams a tick of 960 frames
    while tx.tick():
        for _ in range(n_pkts):
            assert rx.tick()
            while (s := rx.get_by_name("s").pull_sample()) is not None:
                got.append(np.asarray(s.buffer.data))
    tx.set_state("null")
    rx.set_state("null")
    np.testing.assert_array_equal(np.concatenate(got), x)


def test_tcp_server_to_client_bytes():
    """tcpserversink to tcpclientsrc on the port: the bytes arrive whole
    (a client that registered is waited for, not slept on)."""
    payload = np.random.default_rng(0).integers(0, 256, 50000, np.uint8)
    srv = tparse_launch("appsrc name=in caps=application/octet-stream ! "
                        "tcpserversink name=snd port=0", device="cpu")
    srv.get_by_name("in").push_buffer(Buffer(data=payload, batch=1))
    srv.set_state("playing")
    snd = srv.get_by_name("snd")
    cli = tparse_launch(f"tcpclientsrc port={snd.bound_port} timeout=2.0 ! "
                        "appsink name=s", device="cpu")
    cli.set_state("playing")
    _until(lambda: snd._clients, "client")
    assert srv.tick()
    got = bytearray()
    while len(got) < payload.nbytes and cli.tick():
        while (s := cli.get_by_name("s").pull_sample()) is not None:
            got += np.asarray(s.buffer.data).tobytes()
    srv.set_state("null")
    cli.set_state("null")
    assert bytes(got) == payload.tobytes()


def test_tcp_client_to_server_thread():
    """tcpclientsink into tcpserversrc, the sender in its own thread."""
    rx = tparse_launch("tcpserversrc name=r port=0 timeout=2.0 ! "
                       "appsink name=s", device="cpu")
    rx.set_state("playing")
    port = rx.get_by_name("r").bound_port
    data = np.arange(4096, dtype=np.uint32).view(np.uint8)
    tx = tparse_launch("appsrc name=in caps=application/octet-stream ! "
                       f"tcpclientsink port={port}", device="cpu")
    tx.get_by_name("in").push_buffer(Buffer(data=data, batch=1))
    t = threading.Thread(target=lambda: (tx.set_state("playing"), tx.tick()))
    t.start()
    got = bytearray()
    while len(got) < data.nbytes and rx.tick():
        while (s := rx.get_by_name("s").pull_sample()) is not None:
            got += np.asarray(s.buffer.data).tobytes()
    t.join(DEADLINE)
    tx.set_state("null")
    rx.set_state("null")
    assert bytes(got) == data.tobytes()


def test_udpsink_chunks_a_byte_buffer_as_the_reference():
    """A byte buffer goes out in mtu-sized datagrams, as the JAX udpsink
    cuts it."""
    payload = np.random.default_rng(2).integers(0, 256, 5000, np.uint8)
    got = {}
    for tag, parse, buf_cls, kw in (
            ("port", tparse_launch, Buffer, {"device": "cpu"}),
            ("jax", jparse_launch, JBuffer, {})):
        rs = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rs.bind(("127.0.0.1", 0))
        rs.settimeout(DEADLINE)
        tx = parse(f"appsrc name=in caps=application/octet-stream ! "
                   f"udpsink port={rs.getsockname()[1]} mtu=1200", **kw)
        tx.get_by_name("in").push_buffer(buf_cls(data=payload, batch=1))
        tx.set_state("playing")
        assert tx.tick()
        got[tag] = [rs.recvfrom(65536)[0] for _ in range(5)]
        tx.set_state("null")
        rs.close()
    assert got["port"] == got["jax"]
    assert b"".join(got["port"]) == payload.tobytes()
