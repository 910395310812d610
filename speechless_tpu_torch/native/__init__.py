"""Native (C++) host routines of the port, loaded with ctypes: edit distance for evaluation
(``levenshtein.cpp``), the ARPA n-gram scorer (``ngram_lm.cpp``), the threaded CTC
prefix beam with word-LM fusion that the facade evaluates with (``beam_search.cpp``) and
the FLAC decoder of `features/audio_io.py` (``flac.cpp``).

The sources are the port's own copies of the JAX package's ``native/``. Nothing is
built at import: `library()`
compiles them at first use with ``g++ -O3 -fPIC -shared -std=c++17 -pthread`` into
``build/speechless_tpu_torch_native/<hash>.so`` beside the package, where the hash
covers the sources and the flags, so an edited source is rebuilt and never confused
with a stale library. A failed build raises.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("levenshtein.cpp", "ngram_lm.cpp", "beam_search.cpp", "flac.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "speechless_tpu_torch_native"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_library: Optional["NativeLibrary"] = None


def _target() -> Path:
    digest = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode() + (SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / "{}.so".format(digest.hexdigest()[:16])


def build() -> Path:
    """Compile the library unless a build of these sources and flags exists; return its
    path. The compiler writes a temporary file that is renamed into place, so processes
    that build at once never load a half-written library."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    handle, temporary = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(handle)
    command = (["g++", *GXX_FLAGS, "-o", temporary]
               + [str(SOURCE_DIR / name) for name in SOURCES])
    try:
        result = subprocess.run(command, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError("building the native library failed ({}):\n{}".format(
                " ".join(command), result.stderr[-4000:]))
        os.replace(temporary, target)
    finally:
        if os.path.exists(temporary):
            os.unlink(temporary)
    return target


def library() -> "NativeLibrary":
    """The loaded library, built on the first call."""
    global _library
    with _lock:
        if _library is None:
            _library = NativeLibrary(ctypes.CDLL(str(build())))
        return _library


_P = ctypes.c_void_p
_FP = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)


class NativeLibrary:
    """Typed entry points of the shared library."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.sl_levenshtein.restype = ctypes.c_int64
        lib.sl_levenshtein.argtypes = [_U32P, ctypes.c_int64, _U32P, ctypes.c_int64]
        lib.sl_ngram_load.restype = _P
        lib.sl_ngram_load.argtypes = [ctypes.c_char_p]
        lib.sl_ngram_free.restype = None
        lib.sl_ngram_free.argtypes = [_P]
        lib.sl_ngram_order.restype = ctypes.c_int
        lib.sl_ngram_order.argtypes = [_P]
        lib.sl_ngram_score_word.restype = ctypes.c_float
        lib.sl_ngram_score_word.argtypes = [_P, ctypes.c_char_p, ctypes.c_char_p]
        lib.sl_ngram_is_valid_word.restype = ctypes.c_int
        lib.sl_ngram_is_valid_word.argtypes = [_P, ctypes.c_char_p]
        lib.sl_ctc_beam_search.restype = ctypes.c_int
        lib.sl_ctc_beam_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _I32P, ctypes.c_int, ctypes.c_int, _P, _U32P, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int, _I32P, _I32P]
        lib.sl_decode_flac.restype = ctypes.c_int
        lib.sl_decode_flac.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FP),
                                       ctypes.POINTER(ctypes.c_int64), _I32P]
        lib.sl_free_buffer.restype = None
        lib.sl_free_buffer.argtypes = [_FP]

    def levenshtein(self, a: str, b: str) -> int:
        def codepoints(text: str):
            if not text:
                return (ctypes.c_uint32 * 1)()
            return (ctypes.c_uint32 * len(text)).from_buffer_copy(text.encode("utf-32-le"))
        return int(self._lib.sl_levenshtein(codepoints(a), len(a), codepoints(b), len(b)))

    def ngram_load(self, path: str) -> int:
        handle = self._lib.sl_ngram_load(path.encode())
        if not handle:
            raise ValueError("Failed to load ARPA language model from {}".format(path))
        return handle

    def ngram_free(self, handle: int) -> None:
        self._lib.sl_ngram_free(handle)

    def ngram_order(self, handle: int) -> int:
        return int(self._lib.sl_ngram_order(handle))

    def ngram_score_word(self, handle: int, context: str, word: str) -> float:
        return float(self._lib.sl_ngram_score_word(handle, context.encode(), word.encode()))

    def ngram_is_valid_word(self, handle: int, word: str) -> bool:
        return bool(self._lib.sl_ngram_is_valid_word(handle, word.encode()))

    def ctc_beam_search(self, log_probs, lengths: Sequence[int], blank: int, beam_width: int,
                        lm_handle: int = 0, alphabet: Optional[List[str]] = None,
                        space_index: int = -1, lm_weight: float = 0.8,
                        word_count_weight: float = 0.0,
                        valid_word_count_weight: float = 2.3,
                        class_log_prob_floor: float = 0.0,
                        num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Batched CTC prefix beam search. Returns ``tokens (batch, t_max) int32``
        (-1 padded) and ``counts (batch,) int32``. ``class_log_prob_floor`` < 0 skips
        extensions by classes below it each frame (0.0: exact); ``num_threads`` 0 uses
        ``std::thread::hardware_concurrency()`` threads."""
        log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
        batch, t_max, classes = log_probs.shape
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        tokens = np.empty((batch, t_max), dtype=np.int32)
        counts = np.empty(batch, dtype=np.int32)
        codepoints = (np.array([ord(c) for c in alphabet], dtype=np.uint32)
                      if alphabet is not None else None)
        status = self._lib.sl_ctc_beam_search(
            log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch, t_max, classes,
            lengths.ctypes.data_as(_I32P), blank, beam_width, _P(lm_handle or None),
            codepoints.ctypes.data_as(_U32P) if codepoints is not None else None,
            space_index, lm_weight, word_count_weight, valid_word_count_weight,
            class_log_prob_floor, num_threads, tokens.ctypes.data_as(_I32P),
            counts.ctypes.data_as(_I32P))
        if status != 0:
            raise ValueError("native beam search failed (status {})".format(status))
        return tokens, counts

    def decode_flac(self, path: str) -> Tuple[np.ndarray, int]:
        """Decode a FLAC file to ``(mono float32 samples, sample rate)``: channels are
        averaged, 16-bit samples scaled by 1/32768. Raises ValueError for a file the
        decoder refuses (corrupt, truncated, an unsupported subset)."""
        samples = _FP()
        count = ctypes.c_int64()
        sample_rate = ctypes.c_int32()
        status = self._lib.sl_decode_flac(path.encode(), ctypes.byref(samples),
                                          ctypes.byref(count), ctypes.byref(sample_rate))
        if status != 0:
            raise ValueError("FLAC decode failed for {} (error {})".format(path, status))
        try:
            audio = np.ctypeslib.as_array(samples, shape=(count.value,)).copy()
        finally:
            self._lib.sl_free_buffer(samples)
        return audio, int(sample_rate.value)
