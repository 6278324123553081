"""The native (C++) telemetry sink, loaded with ctypes.

Counterpart of `tpu_dialmpc/native/__init__.py`, on the same C ABI.
`load_telemetry_sink()` builds the port's own copy of the source
(`csrc/telemetry_sink.cpp`) with `dynamics/_build.py`'s host build into
`build/kernels/` at first use and loads it; it returns None where it cannot
be built or loaded (no C++ toolchain), and `NativeSink` then raises
RuntimeError with the reason.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from tpu_dialmpc_torch.dynamics import _build

SOURCE = "telemetry_sink.cpp"
_lib_handle = None
_last_error: Optional[str] = None


def load_telemetry_sink():
    """The sink's library with its ctypes signatures, or None."""
    global _lib_handle, _last_error
    if _lib_handle is not None:
        return _lib_handle
    try:
        path, _, _ = _build.build(SOURCE, {}, host=True)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:  # no compiler, a failed build or load
        _last_error = str(e)
        return None
    lib.ts_create.restype = ctypes.c_void_p
    lib.ts_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ts_push.restype = ctypes.c_int
    lib.ts_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ts_accepted.restype = ctypes.c_long
    lib.ts_accepted.argtypes = [ctypes.c_void_p]
    lib.ts_dropped.restype = ctypes.c_long
    lib.ts_dropped.argtypes = [ctypes.c_void_p]
    lib.ts_close.restype = None
    lib.ts_close.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


class NativeSink:
    """Thin ctypes wrapper over the C++ ring-buffer sink, which writes one
    JSONL line per accepted push to `path`.  `accepted` and `dropped` keep
    their last counts after `close`."""

    def __init__(self, path: str, capacity: int = 8192):
        lib = load_telemetry_sink()
        if lib is None:
            raise RuntimeError(f"native telemetry sink unavailable: {_last_error}")
        self._lib = lib
        self._h = lib.ts_create(str(path).encode(), capacity)
        self._final = (0, 0)

    def push(self, line: str) -> bool:
        data = line.encode()
        return bool(self._lib.ts_push(self._h, data, len(data)))

    @property
    def accepted(self) -> int:
        return self._lib.ts_accepted(self._h) if self._h else self._final[0]

    @property
    def dropped(self) -> int:
        return self._lib.ts_dropped(self._h) if self._h else self._final[1]

    def close(self):
        """Drain the ring to the file, flush, and join the writer."""
        if self._h:
            self._final = (self.accepted, self.dropped)
            self._lib.ts_close(self._h)
            self._h = None
