"""Native (C++) host rasterizer, built on first use and bound via ctypes."""

from .binding import NativeRasterizer

__all__ = ["NativeRasterizer"]
