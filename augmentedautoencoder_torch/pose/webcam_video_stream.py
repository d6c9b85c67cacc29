"""Threaded frame reader and the demos' window (port of
augmentedautoencoder_tpu/pose/webcam_video_stream.py; reference
auto_pose/test/webcam_video_stream.py): a daemon thread keeps grabbing
frames so consumers always read the latest.

Two seams keep OpenCV out of the port:
  * the capture: `WebcamVideoStream(src, ..., capture=fn)` calls
    `fn(src)` for an object with `read() -> (grabbed, frame)`,
    `set(prop, value)` and `release()`; by default `opencv_capture`;
  * the display: an object with `imshow(name, img)` and `wait_key(ms) ->
    int`, handed to the demo CLIs; by default `OpenCVDisplay()`.
Both defaults import `cv2` inside the call, and only there; without
OpenCV they raise a RuntimeError that names the missing backend. Nothing
else in the port imports cv2.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

#: cv2.CAP_PROP_FRAME_WIDTH / CAP_PROP_FRAME_HEIGHT
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4


def _cv2(what: str):
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            f"no {what} backend: the default {what} needs OpenCV (cv2), which does not "
            f"import here; pass your own {what} to the demo instead"
        ) from exc
    return cv2


def opencv_capture(src):
    """The default capture: `cv2.VideoCapture(src)`."""
    return _cv2("camera").VideoCapture(src)


class OpenCVDisplay:
    """The default display: `cv2.imshow` and `cv2.waitKey`."""

    def __init__(self):
        self._cv2 = _cv2("window")

    def imshow(self, name: str, img) -> None:
        self._cv2.imshow(name, img)

    def wait_key(self, ms: int) -> int:
        return self._cv2.waitKey(ms)


class WebcamVideoStream:
    def __init__(self, src: int = 0, width: Optional[int] = None, height: Optional[int] = None,
                 capture: Optional[Callable] = None):
        self.stream = (capture or opencv_capture)(src)
        if width:
            self.stream.set(CAP_PROP_FRAME_WIDTH, width)
        if height:
            self.stream.set(CAP_PROP_FRAME_HEIGHT, height)
        self.grabbed, self.frame = self.stream.read()
        self.stopped = False
        self._lock = threading.Lock()
        self._thread = None

    def start(self) -> "WebcamVideoStream":
        self._thread = threading.Thread(target=self._update, daemon=True)
        self._thread.start()
        return self

    def _update(self) -> None:
        while not self.stopped:
            grabbed, frame = self.stream.read()
            with self._lock:
                self.grabbed, self.frame = grabbed, frame

    def read(self):
        with self._lock:
            return self.frame

    def stop(self) -> None:
        self.stopped = True
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self.stream.release()
