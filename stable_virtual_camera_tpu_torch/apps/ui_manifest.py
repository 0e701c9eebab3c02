"""Pinned UI-API surface of the gradio and viser shells.

A copy of stable_virtual_camera_tpu/apps/ui_manifest.py. The port's shells
(apps/gradio_app.py, apps/viser_gui.py) consume exactly this surface of
gradio 5.17 and viser, the reference demo's pinned versions. `check_gradio`
and `check_viser` hold an installed package, or a stand-in (the tests'
fakes, chip_smoke.py's), to it at startup, so that drift fails loudly
instead of misbehaving.
"""

from __future__ import annotations

GRADIO_PIN = "5.17"  # the reference demo's pinned gradio==5.17.0

# Symbols of the gradio module the app instantiates or raises.
GRADIO_SYMBOLS = (
    "Blocks",
    "Button",
    "Dropdown",
    "Error",
    "File",
    "HTML",
    "Image",
    "Info",
    "Number",
    "Progress",
    "Request",
    "Slider",
    "State",
    "Tab",
    "Video",
)
# Methods called on a Blocks instance.
GRADIO_BLOCKS_METHODS = ("load", "unload", "queue", "launch")
# Event wiring used on widgets (gradio exposes these per-widget instance).
GRADIO_WIDGET_EVENTS = ("click",)

# viser.ViserServer attribute paths the GUI layers touch.
VISER_SYMBOLS = ("ViserServer", "Icon")
VISER_SERVER_METHODS = ("stop", "get_clients")
VISER_GUI_METHODS = (
    "add_button",
    "add_checkbox",
    "add_dropdown",
    "add_folder",
    "add_number",
    "add_slider",
)
# used on per-client gui handles only (client.gui.add_modal)
VISER_CLIENT_GUI_METHODS = ("add_modal",)
VISER_SCENE_METHODS = (
    "add_camera_frustum",
    "add_spline_catmull_rom",
)
# Attributes used on returned GUI handles.
VISER_HANDLE_ATTRS = ("on_click", "on_update", "remove", "value", "visible",
                      "disabled")
# Attributes used on client camera handles.
VISER_CAMERA_ATTRS = ("fov", "position", "wxyz")


class UiApiDrift(RuntimeError):
    """The installed UI package no longer matches the pinned surface."""


def _require(obj, names, where: str) -> list[str]:
    return [f"{where}.{n}" for n in names if not hasattr(obj, n)]


def check_gradio(gr) -> None:
    """Assert the gradio module exposes the pinned surface; raise UiApiDrift
    listing every missing symbol. Version-gated: a non-5.17 real gradio still
    passes if the surface is intact (minor releases rarely drop widgets)."""
    missing = _require(gr, GRADIO_SYMBOLS, "gradio")
    blocks = getattr(gr, "Blocks", None)
    if blocks is not None:
        missing += _require(blocks, GRADIO_BLOCKS_METHODS, "gradio.Blocks")
    if missing:
        version = getattr(gr, "__version__", "unknown")
        raise UiApiDrift(
            f"gradio {version} drifted from the pinned =={GRADIO_PIN} "
            f"surface; missing: {', '.join(missing)}"
        )


def check_viser(viser_mod, server=None) -> None:
    """Assert the viser module (and optionally a live server instance)
    exposes the pinned surface."""
    missing = _require(viser_mod, VISER_SYMBOLS, "viser")
    if server is not None:
        missing += _require(server, VISER_SERVER_METHODS, "ViserServer")
        missing += _require(
            getattr(server, "gui", server), VISER_GUI_METHODS, "ViserServer.gui"
        )
        missing += _require(
            getattr(server, "scene", server),
            VISER_SCENE_METHODS,
            "ViserServer.scene",
        )
    if missing:
        raise UiApiDrift(
            "viser drifted from the pinned surface; missing: "
            + ", ".join(missing)
        )
