"""Optional libacars-2 binding for the primary ACARS decode path.

The reference's main ACARS decoder is libacars-2 (ARINC-622 ADS-C/CPDLC
application decoding and multi-block reassembly), with the manual field
parser as fallback (`sbd_acars.c:410-601` vs `:603-996`). This module is
the same split for this package: a ctypes binding loaded lazily; if
the shared library is absent, `load()` returns None and the decoder
falls back to `AcarsDecoder._acars_parse`.

Binding design: only string-level tree APIs are used
(`la_acars_parse_and_reassemble` -> `la_proto_tree_format_json` /
`_format_text`), never the `la_acars_msg` struct layout — the JSON
rendering carries every field the outputs need (mode/reg/label/ack/
msg_text/arinc622 subtrees...) and is stable across libacars-2.x,
whereas the struct layout is not an ABI promise. `la_vstring` (str/len/
allocated) is the one struct we mirror; it has been layout-stable since
libacars 1.0.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json

# la_msg_dir (libacars/libacars.h): unknown=0, gnd2air=1, air2gnd=2
LA_MSG_DIR_GND2AIR = 1
LA_MSG_DIR_AIR2GND = 2

_SONAMES = ("libacars-2.so.2", "libacars-2.so", "libacars.so.2",
            "libacars.so")


class _LaVstring(ctypes.Structure):
    _fields_ = [("str", ctypes.c_char_p),
                ("len", ctypes.c_size_t),
                ("allocated_size", ctypes.c_size_t)]


class _Timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class ParsedAcars:
    """One parsed message: the libacars JSON tree (as a Python dict,
    top-level key "acars") plus the formatted text rendering."""

    def __init__(self, tree: dict, text: str):
        self.tree = tree
        self.text = text

    @property
    def acars(self) -> dict:
        return self.tree.get("acars", {})

    @property
    def err(self) -> bool:
        return bool(self.acars.get("err", False))

    @property
    def reasm_in_progress(self) -> bool:
        # libacars renders reasm_status as a string when reassembly is on
        return self.acars.get("reasm_status") in ("in progress",
                                                  "IN_PROGRESS")


class LibAcars:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.la_acars_parse_and_reassemble.restype = ctypes.c_void_p
        lib.la_acars_parse_and_reassemble.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, _Timeval]
        lib.la_proto_tree_format_json.restype = ctypes.POINTER(_LaVstring)
        lib.la_proto_tree_format_json.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_void_p]
        lib.la_proto_tree_format_text.restype = ctypes.POINTER(_LaVstring)
        lib.la_proto_tree_format_text.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_void_p]
        lib.la_vstring_destroy.restype = None
        lib.la_vstring_destroy.argtypes = [ctypes.POINTER(_LaVstring),
                                           ctypes.c_bool]
        lib.la_proto_tree_destroy.restype = None
        lib.la_proto_tree_destroy.argtypes = [ctypes.c_void_p]
        lib.la_reasm_ctx_new.restype = ctypes.c_void_p
        lib.la_reasm_ctx_new.argtypes = []
        self._reasm = lib.la_reasm_ctx_new()

    def parse(self, data: bytes, ul: bool,
              unix_time: float) -> ParsedAcars | None:
        """la_acars_parse_and_reassemble + JSON/text rendering.
        `data` is the payload AFTER the SOH (0x01) and iridium 0x03
        header strip (the caller does the stripping, like
        sbd_acars.c:466-482)."""
        tv = _Timeval(int(unix_time),
                      int((unix_time - int(unix_time)) * 1e6))
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        direction = LA_MSG_DIR_AIR2GND if ul else LA_MSG_DIR_GND2AIR
        tree = self._lib.la_acars_parse_and_reassemble(
            buf, len(data), direction, self._reasm, tv)
        if not tree:
            return None
        try:
            vj = self._lib.la_proto_tree_format_json(None, tree)
            vt = self._lib.la_proto_tree_format_text(None, tree)
            try:
                tree_json = json.loads(
                    vj.contents.str.decode("utf-8", "replace")) \
                    if vj and vj.contents.str else {}
                text = vt.contents.str.decode("utf-8", "replace") \
                    if vt and vt.contents.str else ""
            finally:
                if vj:
                    self._lib.la_vstring_destroy(vj, True)
                if vt:
                    self._lib.la_vstring_destroy(vt, True)
        finally:
            self._lib.la_proto_tree_destroy(tree)
        if "acars" not in tree_json:
            return None
        return ParsedAcars(tree_json, text)


def load() -> LibAcars | None:
    """Try to bind libacars-2; None if unavailable (the decoder then
    uses the fallback parser, mirroring the reference's HAVE_LIBACARS
    compile-time split)."""
    for name in _SONAMES:
        try:
            return LibAcars(ctypes.CDLL(name))
        except OSError:
            continue
        except AttributeError:
            # library found but entry points missing (wrong major)
            return None
    path = ctypes.util.find_library("acars-2")
    if path:
        try:
            return LibAcars(ctypes.CDLL(path))
        except (OSError, AttributeError):
            return None
    return None
