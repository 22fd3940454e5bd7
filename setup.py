"""Build/packaging (parity: reference python/setup.py + root Makefile
feature-flag build — SURVEY.md §2.6 "Build system").

Installs the ``mxnet_tpu`` package and compiles the native runtime
``libmxtpu.so`` from ``src/`` as part of ``build_py`` (the library is
also auto-built on first import when a toolchain is present, so a plain
checkout works without installing).

    pip install -e .            # editable, with native build
    MXTPU_SKIP_NATIVE=1 pip install .   # pure-Python fallback paths
"""
import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py as _build_py

HERE = os.path.dirname(os.path.abspath(__file__))


class build_py(_build_py):
    def run(self):
        if not os.environ.get("MXTPU_SKIP_NATIVE"):
            try:
                subprocess.run(["make", "-C",
                                os.path.join(HERE, "src")], check=True)
            except Exception as e:  # degrade like _native.available()
                print(f"warning: native build failed ({e}); "
                      "pure-Python fallbacks will be used")
        super().run()


setup(
    name="mxnet_tpu",
    version="0.2.0",
    description=("TPU-native deep-learning framework with MXNet's "
                 "capabilities (JAX/XLA/Pallas compute, C++ runtime)"),
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu": ["lib/libmxtpu.so",
                                "lib/libmxtpu_image.so",
                                "lib/libmxtpu_pjrt.so"],
                  # CUDA sources, built with nvcc at first use
                  "mxnet_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"checkpoint": ["orbax-checkpoint"]},
    cmdclass={"build_py": build_py},
    scripts=["tools/launch.py", "tools/im2rec.py"],
)
