"""Element presets — named property bundles persisted to disk.

Reference: subprojects/gstreamer/gst/gstpreset.c (1514 LoC) — per-factory
preset files with named property sets, user dir overriding system dir.

Format here: one INI-style file per factory under
$GTPU_PRESET_PATH (default ~/.config/gstreamer_tpu/presets/<factory>.prs).

A copy of the JAX package's ``core/preset.py`` (host only).
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, List, Optional


def _preset_dir() -> str:
    return os.environ.get(
        "GTPU_PRESET_PATH",
        os.path.expanduser("~/.config/gstreamer_tpu/presets"))


def _path_for(factory: str) -> str:
    return os.path.join(_preset_dir(), f"{factory}.prs")


def get_preset_names(factory: str) -> List[str]:
    path = _path_for(factory)
    if not os.path.exists(path):
        return []
    cp = configparser.ConfigParser()
    cp.read(path)
    return [s for s in cp.sections()]


def save_preset(element, name: str) -> None:
    """gst_preset_save_preset: snapshot current property values."""
    os.makedirs(_preset_dir(), exist_ok=True)
    path = _path_for(element.FACTORY)
    cp = configparser.ConfigParser()
    cp.read(path)
    if not cp.has_section(name):
        cp.add_section(name)
    for key in element.PROPERTIES:
        val = element.props.get(key)
        if val is not None and not isinstance(val, (dict, list, tuple)):
            cp.set(name, key, str(val))
    with open(path, "w") as f:
        cp.write(f)


def load_preset(element, name: str) -> bool:
    """gst_preset_load_preset: apply a named preset's properties."""
    path = _path_for(element.FACTORY)
    cp = configparser.ConfigParser()
    cp.read(path)
    if not cp.has_section(name):
        return False
    for key, val in cp.items(name):
        try:
            element.set_property(key, val)
        except ValueError:
            pass
    return True


def delete_preset(factory: str, name: str) -> bool:
    path = _path_for(factory)
    cp = configparser.ConfigParser()
    cp.read(path)
    if not cp.has_section(name):
        return False
    cp.remove_section(name)
    with open(path, "w") as f:
        cp.write(f)
    return True
