"""Optional custom Streamlit camera component (rear camera, full-res): the
port's copy of ``twinvoice_tpu/app/camera_component`` (Streamlit and
Pillow are imported inside the functions that use them).

Equivalent of the reference's ``camera_component`` package
(camera_component/__init__.py:1-10 + frontend/index.html): a
``getUserMedia``-based capture widget preferring the rear camera at
1920×1080, returning a JPEG data-URL through the Streamlit component bridge.
The built-in ``st.camera_input`` remains the default capture path (as in the
reference's live tab); this component exists for kiosks/tablets that need
the environment-facing camera.
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional

_FRONTEND = os.path.join(os.path.dirname(__file__), "frontend")


def declare():
    """Register the component (requires streamlit)."""
    import streamlit.components.v1 as components

    return components.declare_component("twinvoice_camera", path=_FRONTEND)


def data_url_to_image(data_url: str):
    """`data:image/jpeg;base64,...` → PIL.Image (RGB), or None."""
    from PIL import Image

    if not data_url or "," not in data_url:
        return None
    payload = data_url.split(",", 1)[1]
    try:
        return Image.open(io.BytesIO(base64.b64decode(payload))).convert("RGB")
    except Exception:
        return None


def camera(key: Optional[str] = None):
    """Render the widget; returns a PIL image when a photo is taken."""
    component = declare()
    return data_url_to_image(component(key=key, default=""))
