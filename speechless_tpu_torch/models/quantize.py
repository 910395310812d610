"""Weight-only int8 quantization for inference (port of
`speechless_tpu/models/quantize.py`; numpy, bitwise the JAX module's results).

Quantization is symmetric per output channel (the last axis of the JAX layout's
``(K, Cin, Cout)`` conv weights): ``w ~= w_q * w_scale`` with ``w_q`` int8 in [-127, 127]
and ``w_scale`` float32 of shape ``(Cout,)``. Biases and any other leaves stay float.
`models/wav2letter.py` serves either layout: a quantized layer keeps ``w_q`` and
``w_scale`` on the device (a quarter of the fp32 weights' memory) and dequantizes in its
forward. Training always uses float weights.
"""
from typing import Dict, List

import numpy as np

Params = List[Dict[str, np.ndarray]]

INT8_MAX = 127.0


def quantize_params_int8(params: Params) -> List[dict]:
    """Symmetric per-output-channel int8 quantization of every conv weight: each
    ``{"w": ...}`` becomes ``{"w_q": int8, "w_scale": float32[out_channels]}``; every
    other key passes through unchanged (as numpy)."""
    quantized = []
    for layer in params:
        qlayer = {}
        for key, value in layer.items():
            if key == "w":
                w = np.asarray(value, dtype=np.float32)
                scale = np.maximum(np.max(np.abs(w), axis=(0, 1)) / INT8_MAX, 1e-12)
                qlayer["w_q"] = np.clip(np.round(w / scale), -INT8_MAX, INT8_MAX
                                        ).astype(np.int8)
                qlayer["w_scale"] = scale.astype(np.float32)
            else:
                qlayer[key] = np.asarray(value)
        quantized.append(qlayer)
    return quantized


def dequantize_params(qparams: List[dict]) -> Params:
    """The inverse layout transform: ``w = w_q * w_scale`` as float32 (lossy only by the
    quantization's own rounding)."""
    params = []
    for qlayer in qparams:
        layer = dict(qlayer)
        if "w_q" in layer:
            layer["w"] = (layer.pop("w_q").astype(np.float32) * layer.pop("w_scale"))
        params.append(layer)
    return params


def quantization_error(params: Params) -> float:
    """Max absolute weight error of a quantize -> dequantize round trip."""
    round_trip = dequantize_params(quantize_params_int8(params))
    return max(float(np.max(np.abs(np.asarray(a["w"], np.float32)
                                   - np.asarray(b["w"], np.float32))))
               for a, b in zip(params, round_trip) if "w" in a)
