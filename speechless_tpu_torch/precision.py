"""IEEE fp32 for the serving path's matmuls and convolutions.

The JAX package computes features at `Precision.HIGHEST` and the model in fp32.
PyTorch runs cuDNN convolutions in TF32 (a 10-bit mantissa) on Ampere and later
unless told otherwise, so the port turns TF32 off where it computes instead of relying
on process-wide settings made by its caller.
"""
import threading
from contextlib import contextmanager

import torch

_lock = threading.Lock()
_depth = 0
_saved = None


@contextmanager
def ieee_fp32():
    """Run the enclosed CUDA matmuls and cuDNN convolutions without TF32.

    The flags are process-wide: the first of any overlapping entries (from any thread)
    saves and clears them, and the last exit restores them.
    """
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _saved
