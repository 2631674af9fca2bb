"""Optional host libraries, imported at the call that needs them.

PIL reads and writes the PNGs of the CAMUS layout and the eval overlays;
OpenCV decodes and writes EchoNet's AVI files.  Neither is needed to import
the package, to train on packed or synthetic data, or to run a kernel.
"""

from __future__ import annotations


def require_pil(what: str):
    """``PIL.Image``, or an ImportError naming what needed it."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"{what} needs PIL (the Pillow package) to read and write PNG "
            f"files; it is not installed") from exc
    return Image


def has_pil() -> bool:
    try:
        require_pil("has_pil")
    except ImportError:
        return False
    return True


def require_cv2(what: str):
    """The ``cv2`` module, or an ImportError naming what needed it."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            f"{what} needs OpenCV (the cv2 module) to decode and write AVI "
            f"files; it is not installed") from exc
    return cv2
