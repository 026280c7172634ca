"""Build for the devicekmc_tpu package and its C++ runtime extension.

    python setup.py build_ext --inplace

The extension is optional: the Python layer falls back to numpy
implementations when ``devicekmc_native`` is absent.
"""

import numpy as np
from setuptools import Extension, setup

setup(
    name="devicekmc_tpu",
    version="0.1.0",
    packages=[
        "devicekmc_tpu",
        "devicekmc_tpu.ops",
        "devicekmc_tpu.physics",
        "devicekmc_tpu.parallel",
        "devicekmc_tpu.postprocessing",
        "devicekmc_tpu_torch",
        "devicekmc_tpu_torch.ops",
        "devicekmc_tpu_torch.physics",
        "devicekmc_tpu_torch.parallel",
        "devicekmc_tpu_torch.io",
        "devicekmc_tpu_torch.postprocessing",
    ],
    package_data={"devicekmc_tpu_torch": ["csrc/*.cu"]},
    ext_modules=[
        Extension(
            "devicekmc_native",
            sources=["native/devicekmc_native.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-fopenmp", "-march=native"],
            extra_link_args=["-fopenmp"],
        )
    ],
)
