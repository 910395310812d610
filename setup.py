"""Packaging for speechless_tpu (replaces the reference's distutils setup,
`/root/reference/setup.py`). The C++ natives (Levenshtein, FLAC, n-gram) compile on first
import via g++ (see speechless_tpu/native); no build-time extension step is required."""
from setuptools import find_packages, setup

setup(
    name="speechless-tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) wav2letter speech recognition framework",
    packages=find_packages(exclude=("tests",)),
    package_data={"speechless_tpu.native": ["*.cpp"],
                  "speechless_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "scipy",
    ],
    extras_require={
        "plot": ["matplotlib"],
        "record": ["sounddevice"],
        "test": ["pytest", "torch"],
    },
)
