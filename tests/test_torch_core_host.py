"""The port's host copies for multi-stream sources against the JAX package:
``utils/typefind.py`` (the corpus of heads of ``tests/test_typefind.py``
and seeded noise), ``core/streams.py``, ``core/collectpads.py``,
``core/preset.py``, ``core/bitstream.py`` and ``core/baseparse.py``.  The
same calls go to both packages and give the same values, tolerance 0.
"""

import threading

import numpy as np
import pytest
import torch

from gstreamer_tpu.core import baseparse as jbp
from gstreamer_tpu.core import bitstream as jbs
from gstreamer_tpu.core import collectpads as jcp
from gstreamer_tpu.core import preset as jpre
from gstreamer_tpu.core import streams as jst
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import PadDirection as JDir
from gstreamer_tpu.core.element import PadTemplate as JTmpl
from gstreamer_tpu.utils import typefind as jtf

from gstreamer_tpu_torch.core import baseparse as tbp
from gstreamer_tpu_torch.core import bitstream as tbs
from gstreamer_tpu_torch.core import collectpads as tcp
from gstreamer_tpu_torch.core import preset as tpre
from gstreamer_tpu_torch.core import streams as tst
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import PadDirection, PadTemplate
from gstreamer_tpu_torch.utils import typefind as ttf

from test_typefind import CASES


# -- typefind -----------------------------------------------------------------

def _noise(seed, n):
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


HEADS = ([head for head, _ in CASES]
         + [bytes(b"\x47" + bytes(187)) * 5, b"", b"\x00" * 64]
         + [_noise(s, n) for s, n in ((0, 16), (1, 64), (2, 512),
                                      (3, 4096))])


@pytest.mark.parametrize("head", HEADS, ids=range(len(HEADS)))
def test_type_find_data(head):
    assert ttf.type_find_data(head) == jtf.type_find_data(head)


def test_typefind_tables():
    assert ttf.DECODABLE == jtf.DECODABLE
    assert len(ttf._FINDERS) == len(jtf._FINDERS)
    for mtype in list(jtf.DECODABLE) + ["video/quicktime, variant=(string)iso",
                                       "audio/mpeg, mpegversion=(int)1, "
                                       "layer=(int)3", "nothing/known"]:
        assert ttf.decodable_for(mtype) == jtf.decodable_for(mtype)


def test_type_find_file(tmp_path):
    for k, (head, _) in enumerate(CASES):
        p = tmp_path / f"{k}.bin"
        p.write_bytes(head + _noise(k, 50_000))
        assert ttf.type_find_file(str(p)) == jtf.type_find_file(str(p))


# -- streams ------------------------------------------------------------------

def _collection(st, caps):
    col = st.StreamCollection("src0")
    col.add_stream(st.Stream("src0/video:0", caps.from_string("video/x-raw"),
                             st.StreamType.VIDEO))
    col.add_stream(st.Stream("src0/audio:0", caps.from_string("audio/x-raw"),
                             st.StreamType.AUDIO))
    return (col.get_size(), col.upstream_id,
            [(s.stream_id, str(s.caps), s.stream_type)
             for s in (col.get_stream(0), col.get_stream(1))])


def _toc(st):
    toc = st.Toc()
    ch1 = st.TocEntry("chapter", "ch.1", start=0, stop=10_000_000_000)
    ch1.append_sub_entry(st.TocEntry("chapter", "ch.1.1", start=0,
                                     stop=5_000_000_000))
    toc.append_entry(ch1)
    hit = toc.find_entry("ch.1.1")
    return (hit.uid, hit.start, hit.stop, toc.find_entry("nope"))


def test_streams_and_toc():
    assert _collection(tst, Caps) == _collection(jst, JCaps)
    assert _toc(tst) == _toc(jst)


@pytest.mark.parametrize("uri", [
    "file:///tmp/a%20file.y4m", "udp://127.0.0.1:5004", "rtsp://h/x",
    "appsrc://", "/no/scheme", "http://example.org/a?b=c"])
def test_uri_helpers(uri):
    for fn in ("uri_is_valid", "uri_get_protocol", "uri_get_location"):
        assert getattr(tst, fn)(uri) == getattr(jst, fn)(uri), fn


def test_element_make_from_uri(tmp_path):
    p = str(tmp_path / "a file.y4m")
    open(p, "wb").write(b"YUV4MPEG2 W64 H48 F30:1\n")
    uri = tst.filename_to_uri(p)
    assert uri == jst.filename_to_uri(p)
    e, j = tst.element_make_from_uri(uri), jst.element_make_from_uri(uri)
    assert (e.FACTORY, e.props) == (j.FACTORY, j.props)
    with pytest.raises(ValueError):
        tst.element_make_from_uri("nope://x")


def test_element_make_from_uri_unported_handler(monkeypatch):
    """A handler whose factory the port does not have yet (chromaprint;
    dvdec, named here before, came with the aliases module): the port
    raises naming ROADMAP.md where the JAX package builds it.  The udp://
    handler's udpsrc is ported: both build it alike."""
    for st in (jst, tst):
        monkeypatch.setitem(st._URI_HANDLERS, "dv", "chromaprint")
    assert jst.element_make_from_uri("dv://x").FACTORY == "chromaprint"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tst.element_make_from_uri("dv://x")
    e = tst.element_make_from_uri("udp://127.0.0.1:5004")
    j = jst.element_make_from_uri("udp://127.0.0.1:5004")
    assert (e.FACTORY, e.props) == (j.FACTORY, j.props) == \
        ("udpsrc", j.props)


def test_context_registry():
    for st in (tst, jst):
        reg = st.ContextRegistry()
        reg.set_context(st.Context("gtpu.device", values={"platform": "x"}))
        assert reg.get_context("gtpu.device").values == {"platform": "x"}
        assert reg.get_context("missing") is None


# -- collectpads --------------------------------------------------------------

def _collect(cp):
    c = cp.CollectPads()
    c.add_pad("a")
    c.add_pad("b")
    c.chain("a", 1)
    out = [c.peek_collected()]
    c.chain("b", 2)
    out.append(c.pop_collected())
    c.chain("a", 3)
    c.eos("b")
    out += [c.pop_collected(), c.all_eos]
    c.eos("a")
    return out + [c.all_eos]


def _dataqueue(cp):
    q = cp.DataQueue(max_items=2)
    log = [q.push(1), q.push(2), q.push(3, timeout=0.02)]
    got = []

    def consumer():
        while (item := q.pop(timeout=1.0)) is not None:
            got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    log.append(q.push(3, timeout=1.0))
    while got != [1, 2, 3] and t.is_alive():
        t.join(0.01)
    q.set_flushing()
    t.join(2.0)
    return log, got


def test_collectpads():
    assert _collect(tcp) == _collect(jcp)
    assert _dataqueue(tcp) == _dataqueue(jcp)


# -- preset -------------------------------------------------------------------

@pytest.mark.parametrize("factory", ["volume", "videobalance"])
def test_preset(factory, tmp_path, monkeypatch):
    """Save, load and delete a preset of a real element in both packages,
    each in its own directory: the same files and the same values."""
    from gstreamer_tpu.core.element import element_factory_make as jmake

    from gstreamer_tpu_torch.core.element import element_factory_make as tmake
    rows, files = {}, {}
    for key, mod, make in (("j", jpre, jmake), ("t", tpre, tmake)):
        monkeypatch.setenv("GTPU_PRESET_PATH", str(tmp_path / key))
        e = make(factory)
        mod.save_preset(e, "first")
        for k, (typ, default, _) in e.PROPERTIES.items():
            if typ is float:
                e.set_property(k, default * 0.5 + 0.25)
            elif typ is bool:
                e.set_property(k, not default)
        mod.save_preset(e, "second")
        f = make(factory)
        loaded = mod.load_preset(f, "second")
        rows[key] = (loaded, sorted((k, str(v)) for k, v in f.props.items()),
                     mod.get_preset_names(factory),
                     mod.delete_preset(factory, "first"),
                     mod.get_preset_names(factory),
                     mod.load_preset(f, "missing"))
        files[key] = (tmp_path / key / f"{factory}.prs").read_bytes()
    assert rows["t"] == rows["j"]
    assert files["t"] == files["j"]


# -- bitstream ----------------------------------------------------------------

def _bits(bs):
    w = bs.BitWriter()
    for v, n in ((5, 3), (1, 1), (0x1234, 16), (3, 2), (0x7FF, 11)):
        w.put_bits(v, n)
    w.align_bytes(1)
    data = w.get_data()
    r = bs.BitReader(data)
    vals = [r.get_bits(n) for n in (3, 1, 16, 2, 11)]
    vals += [r.skip_to_byte(), r.remaining(), r.get_bits(64)]
    bw = bs.ByteWriter()
    bw.put_uint8(7)
    bw.put_uint16_be(0x1234)
    bw.put_uint32_le(0xDEADBEEF)
    bw.put_uint64_le(2**63 + 5)
    bw.put_float32_le(1.5)
    bw.put_data(b"\x00\x00\x01\xb3xyz")
    size = bw.size
    raw = bw.reset_and_get_data()
    br = bs.ByteReader(raw)
    got = [size, br.get_uint8(), br.get_uint16_be(), br.get_uint32_le(),
           br.get_uint64_le(), br.get_float32_le(), br.peek_data(2),
           br.masked_scan_uint32(0xFFFFFFFF, 0x000001B3, 0,
                                 br.remaining()),
           br.get_data(7), br.remaining(), br.get_uint8(), br.skip(1)]
    fc = bs.FlowCombiner()
    flows = [fc.update_flow(p, f) for p, f in (
        ("a", "eos"), ("b", "not-linked"), ("c", "ok"), ("c", "eos"),
        ("b", "eos"), ("a", "error"))]
    fc.remove_pad("a")
    flows.append(fc.update_flow("b", "eos"))
    return data, vals, raw, got, flows


def test_bitstream():
    names = sorted(n for n in dir(jbs) if not n.startswith("_"))
    assert sorted(n for n in dir(tbs) if not n.startswith("_")) == names
    assert _bits(tbs) == _bits(jbs)


# -- baseparse ----------------------------------------------------------------

def _parser(bp, tmpl, caps, direction):
    class SyncFrameParse(bp.BaseParse):
        """Frames 0xA5 <len> <payload>; bytes before a 0xA5 are skipped."""
        FACTORY = "testsyncparse"
        PAD_TEMPLATES = [tmpl("sink", direction.SINK, caps.any()),
                         tmpl("src", direction.SRC, caps.any())]

        def __init__(self, name=None, **props):
            super().__init__(name=name, **props)
            self.set_min_frame_size(2)
            self.set_frame_rate(25, 1)

        def handle_frame(self, view):
            if view[0] != 0xA5:
                skip = int(np.argmax(view == 0xA5))
                return (0, len(view)) if view[skip] != 0xA5 else (0, skip)
            need = 2 + int(view[1])
            return (0, 0) if len(view) < need else (need, 0)
    p = SyncFrameParse()
    p.start()
    return p


def _stream(seed):
    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 0xA0, 5, dtype=np.uint8).tobytes())
    for _ in range(12):
        n = int(rng.integers(0, 9))
        out += bytes([0xA5, n]) + rng.integers(0, 256, n, np.uint8).tobytes()
    return np.frombuffer(bytes(out), np.uint8)


def _parse_rows(p, buffer_cls, chunks, wrap):
    rows = []
    for k, c in enumerate(chunks + [None]):
        buf = None if c is None else buffer_cls(
            data=wrap(c), pts=0 if k == 0 else None, batch=1)
        out = p.host_process(buf)
        rows.append(None if out is None else (
            out.pts, out.batch, out.duration,
            [bytes(np.asarray(f)) for f in out.data]))
    return rows


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("wrap", ["numpy", "tensor"])
def test_baseparse(seed, wrap):
    """The same chunks (split at seeded places, the last one drained)
    give the same framed buffers; the port takes CPU tensors too."""
    data = _stream(seed)
    cuts = sorted(np.random.default_rng(seed).integers(0, len(data), 3))
    chunks = np.split(data, cuts)
    ref = _parse_rows(_parser(jbp, JTmpl, JCaps, JDir), JBuffer, chunks,
                      lambda c: c)
    got = _parse_rows(_parser(tbp, PadTemplate, Caps, PadDirection), Buffer,
                      chunks, (lambda c: c) if wrap == "numpy"
                      else (lambda c: torch.from_numpy(c.copy())))
    assert got == ref
