"""A grid of format pairs x size relations through both packages' converters.

Each of 26 formats (8-bit planar, semi-planar and packed YUV at 4:2:0,
4:2:2, 4:4:4, 4:1:1 and 4:1:0; gray; RGB with and without alpha; 15/16-bit
RGB; 10/12/16-bit YUV, RGB and 2:10:10:10 words) is the input of six
conversions, one a size relation: downscale in "hv" order, downscale in "vh"
order, upscale from an odd size, same size, width only, height only.  The
output format rotates through the same list, so every format is packed as
often as it is unpacked.  The four results (reference numpy gold, reference
jitted on the CPU backend, port on ``device="cpu"``, port numpy gold) must
be equal: integer paths, tolerance 0.
"""

import pytest

from test_torch_generic_converter import check, frames, pair

GRID_FORMATS = [
    "I420", "YV12", "NV12", "Y42B", "YUY2", "UYVY", "Y444", "Y41B", "YUV9",
    "AYUV", "GRAY8", "GRAY16_LE", "RGB", "BGRx", "ARGB", "RGB16", "BGR15",
    "I420_10LE", "I422_12LE", "P010_10LE", "Y444_16LE", "AYUV64", "ARGB64",
    "Y410", "RGB10A2_LE", "BGR10A2_LE",
]

# name -> (input size, output size, scale order the plan must choose)
RELATIONS = {
    "down_hv": ((64, 48), (32, 30), "hv"),
    "down_vh": ((65, 62), (50, 20), "vh"),
    "up_odd": ((33, 17), (65, 33), None),
    "same": ((32, 24), (32, 24), None),
    "width_only": ((64, 24), (40, 24), None),
    "height_only": ((32, 48), (32, 30), None),
}

CASES = [(fi, GRID_FORMATS[(7 * i + 3 * r + 1) % len(GRID_FORMATS)], rel)
         for i, fi in enumerate(GRID_FORMATS)
         for r, rel in enumerate(RELATIONS)]


def test_every_format_is_both_unpacked_and_packed():
    assert {c[0] for c in CASES} == set(GRID_FORMATS)
    assert {c[1] for c in CASES} == set(GRID_FORMATS)


@pytest.mark.parametrize("fi,fo,rel", CASES,
                         ids=[f"{a}-{b}-{r}" for a, b, r in CASES])
def test_format_pair_at_size_relation(fi, fo, rel):
    isz, osz, order = RELATIONS[rel]
    conv, jconv = pair(fi, isz, fo, osz)
    if order:
        assert conv.plan["scale_order"] == order
    check(conv, jconv, frames(conv, 1, len(fi) + len(fo)))
